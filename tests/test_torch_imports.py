"""The port stands alone: no module of ``pwclonet_pylidarslam_torch``, and
neither ``chip_smoke.py`` (nor ``tools/time_point_kernels.py`` and
``tools/cast_check.py``, which it imports, and ``tools/batched_step_nudges.py``, which
imports it) nor the torch entry points (``train_net_torch.py``,
``run_slam_torch.py``, ``replay_slam_torch.py``), imports JAX or the JAX
package, and its entry points run on CUDA unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from pwclonet_pylidarslam_torch.models import PWCLONetConfig
from pwclonet_pylidarslam_torch.slam.deep_odometry import DeepOdometryConfig, PWCLONetOdometry

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pwclonet_pylidarslam_tpu")
SOURCES = sorted((REPO / "pwclonet_pylidarslam_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "train_net_torch.py", REPO / "run_slam_torch.py",
    REPO / "replay_slam_torch.py", REPO / "tools" / "time_point_kernels.py",
    REPO / "tools" / "cast_check.py", REPO / "tools" / "batched_step_nudges.py",
    REPO / "tests" / "_torch_parallel_child.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_sources_exist():
    assert (REPO / "chip_smoke.py").exists()
    assert len(SOURCES) > 10


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    small = PWCLONetConfig(num_points=256, sa_npoints=(64, 32, 16, 8), sa_nsamples=(8, 8, 8, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        PWCLONetOdometry(config=DeepOdometryConfig(model=small, num_points=256))
