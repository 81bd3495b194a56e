"""On the card: each CUDA kernel of ``pwclonet_pylidarslam_torch`` against
its plain PyTorch version, at the shapes of the full-width main path.

Skipped where ``torch.cuda.is_available()`` is false. Imports nothing of
JAX, so it runs on a GPU machine without it:
``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.ops import _cuda
from pwclonet_pylidarslam_torch.ops import fps as tfps
from pwclonet_pylidarslam_torch.ops import gather as tgather
from pwclonet_pylidarslam_torch.ops.knn import knn, knn_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,npoint", [(8192, 2048), (2048, 1024), (1024, 256), (256, 64), (300, 50)])
def test_fps_kernel_matches_plain(cuda_device, rng, n, npoint):
    pts = torch.from_numpy((rng.normal(size=(2, n, 3)) * 10).astype(np.float32)).to(cuda_device)
    pts[0, :5] = 0.0
    out = tfps.furthest_point_sample(pts, npoint)
    ref = tfps.furthest_point_sample_plain(pts, npoint)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,k", [(2048, 8192, 32), (2048, 2048, 6), (256, 64, 8), (64, 10, 4)])
def test_knn_kernel_matches_plain(cuda_device, rng, s, n, k):
    q = torch.from_numpy((rng.normal(size=(2, s, 3)) * 10).astype(np.float32)).to(cuda_device)
    r = torch.from_numpy((rng.normal(size=(2, n, 3)) * 10).astype(np.float32)).to(cuda_device)
    d, i = knn(q, r, k)
    pd, pi = knn_plain(q, r, k)
    # both round every product and sum on its own: bit-exact
    torch.testing.assert_close(d, pd, rtol=0, atol=0)
    torch.testing.assert_close(i, pi, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 19, 35, 67])
def test_gather_kernel_matches_plain(cuda_device, rng, c):
    src = torch.from_numpy(rng.normal(size=(2, 8192, c)).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, 8192, size=(2, 65536)).astype(np.int32)).to(cuda_device)
    torch.testing.assert_close(tgather.gather_points(src, idx),
                               tgather.gather_points_plain(src, idx), rtol=0, atol=0)


@pytest.mark.cuda
def test_launches_are_counted_and_bad_input_raises(cuda_device):
    _cuda.reset_launch_counts()
    pts = torch.rand(1, 64, 3, device=cuda_device) + 0.1
    idx = tfps.furthest_point_sample(pts, 8)
    tgather.gather_points(pts, idx)
    knn(pts, pts, 4)
    assert _cuda.launch_counts() == {"fps": 1, "knn": 1, "gather": 1}
    with pytest.raises(TypeError):
        tgather.gather_points(pts.double(), idx)
    with pytest.raises(ValueError):
        knn(pts, pts, 33)  # above the kernel's sorted-list size
    assert _cuda.launch_counts() == {"fps": 1, "knn": 1, "gather": 1}
