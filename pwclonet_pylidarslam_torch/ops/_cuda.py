"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

At first use every ``csrc/*.cu`` (with the ``*.cuh`` it includes) is
compiled by ``nvcc`` for ``sm_90a`` (one process per source, all started
together) and linked into one shared library with a plain C interface,
which is loaded with ``ctypes``. The library lives in ``build/`` beside the
package (listed in ``.gitignore``) and is named by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is not. Nothing
here runs when the module is imported: the CPU tests import it on machines
with no ``nvcc``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0 and counts
the launch in :data:`LAUNCHES`, so a run can show which kernels it went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# products and sums rounded one by one, as the plain versions round them:
# these kernels are held to the bit
_EXACT = ("--fmad=false",)
# flags of one source beside NVCC_FLAGS; a source not named here is held to a
# tolerance and may contract its multiply-adds
SOURCE_FLAGS = {"fps.cu": _EXACT, "knn.cu": _EXACT, "gather.cu": _EXACT,
                "scatter_add.cu": _EXACT}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types (all return a cudaError_t as int)
_SIGNATURES = {
    # points, mask, b, n, npoint, out, cluster, threads, skeleton, stream
    "pwclo_fps": (_P, _P, _I, _I, _I, _P, _I, _I, _I, _P),
    # query, ref, query mask, ref mask (null or one byte a point), b, s, n, k,
    # out_d, out_i, warps, stream
    "pwclo_knn": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P),
    "pwclo_gather": (_P, _P, _I, _I, _I, _I, _P, _P),
    # updates, idx, b, n, m, c, tile, scratch, scratch ints, out, stream
    "pwclo_scatter_add": (_P, _P, _I, _I, _I, _I, _I, _P, _L, _P, _P),
    # x, params, centres, k, n_layers, c0..c3, block_centres, tile_rows, out, stream
    "pwclo_mlp_maxpool": (_P, _P) + (_I,) * 9 + (_P, _P),
    # center_xyz, grouped_xyz, center_feat, grouped_feat, enc/emb/att packed
    # params, centres, k, cc, cg, then per stack (n, w1, w2, w3) x 3,
    # att_includes_center, tile_centres, out, stream
    "pwclo_attentive_aggregate": (_P,) * 7 + (_I,) * 18 + (_P, _P),
}

# what an entry point returns, beside CUDA's own error codes, for a shape
# its kernel does not take (kUnsupported in csrc/tf32x3.cuh,
# kUnsupportedShape in csrc/scatter_add.cu)
UNSUPPORTED_SHAPE = -1

# launches per kernel since the last reset_launch_counts()
LAUNCHES = {"fps": 0, "knn": 0, "gather": 0, "scatter_add": 0, "mlp_maxpool": 0,
            "attentive_aggregate": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library; returns its path."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
        digest.update(" ".join(SOURCE_FLAGS.get(src.name, ())).encode() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libpwclo_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c", str(src), "-o", str(obj)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name} (rc={proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / f"build_{tag}.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"{lib_path.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def build_log() -> str:
    """The compiler's report (registers, spills) of the library in use."""
    logs = sorted(BUILD_DIR.glob("build_*.log"), key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``; raise on a CUDA error,
    else count one launch of ``kernel``."""
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        err = fn(*args)
    if err == UNSUPPORTED_SHAPE:
        raise ValueError(f"{entry}: the kernel does not take this shape (layer counts, widths "
                         "that do not chain or exceed 128 columns, a tile too large for shared "
                         "memory, or a tile or scratch size it does not take)")
    if err != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {err}")
    LAUNCHES[kernel] += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor the kernel takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must have dtype in {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
