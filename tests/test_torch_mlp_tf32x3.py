"""The precision argument and the tile rule of the fused MLP + max-pool's
CUDA kernel, on the CPU.

``csrc/mlp_maxpool.cu`` runs its stack on the 3xTF32 tensor-core layers of
``csrc/tf32x3.cuh``, from weights that ``ops/tf32x3.py::pack_fragments``
lays out for its one input part ``(Cin,)``. Here the emulation of those
products in ``test_torch_tf32x3.py`` (TF32 rounding on the float32 bits, the
weights read back out of the packed layout) runs the MLP + max-pool at the
eight stacks a full-width fused forward launches (as ``tools/
time_point_kernels.py --ops mlp_maxpool`` records them), with few centres,
and the first pyramid level on raw grouped coordinates at KITTI's reach; it
is held to the port's plain version and to the reference's Pallas kernel
(interpret mode) at the kernel's own tolerance. The tile rule the wrapper
passes to the kernel is checked at the path's calls and at its limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.ops.mlp import mlp_maxpool_plain
from pwclonet_pylidarslam_torch.ops.tf32x3 import (
    TILE_ROWS,
    max_tile_rows,
    mlp_tile,
    pack_fragments,
    packed_fragments,
)
from pwclonet_pylidarslam_tpu.ops.pallas.mlp_kernel import mlp_maxpool_pallas
from test_torch_tf32x3 import _emulated_layer, _stack, _unpack

MLP_TOL = dict(atol=3e-5, rtol=1e-4)  # the kernel's bar against the plain version
# (K, Cin, widths) of the fused MLP's calls in a full-width fused forward:
# the four pyramid levels, the flow-embedding SetConv, the SetUpConvs
PATH_STACKS = [(32, 6, (8, 8, 16)), (32, 19, (16, 16, 32)), (16, 35, (32, 32, 64)),
               (16, 67, (64, 64, 128)), (16, 67, (128, 64, 64)), (8, 67, (128, 64))]
SMS = 132  # an H100 SXM's


def _emulated_mlp_maxpool(x, wb):
    """The kernel's arithmetic: every layer's products in 3xTF32, from the
    weights read back out of the packed layout, summed in fp32; the padded
    columns of each output are zero, and the max runs over the K rows."""
    cin, widths = x.shape[-1], [w.shape[1] for w in wb[0]]
    h = x
    for layer in _unpack(pack_fragments(*wb, (cin,)), (cin,), widths):
        h = _emulated_layer([h], layer)
    return h[..., :widths[-1]].amax(dim=-2)


def _first_level_input(rng, s, k, reach):
    """``[q - p, q]`` (``models/pointnet2.py``): centres uniform in direction
    at 2 m to ``reach`` m, neighbours within about a metre."""
    direction = rng.normal(size=(1, s, 1, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    p = direction * rng.uniform(2.0, reach, size=(1, s, 1, 1))
    q = p + rng.normal(size=(1, s, k, 3)) * 0.5
    return np.concatenate([q - p, q], -1).astype(np.float32)


@pytest.mark.parametrize("k,cin,widths,reach", [*(stack + (0.0,) for stack in PATH_STACKS),
                                                (32, 6, (8, 8, 16), 80.0)])
def test_emulated_tf32x3_mlp_maxpool_matches_plain_and_pallas(rng, k, cin, widths, reach):
    s = 24
    x = (_first_level_input(rng, s, k, reach) if reach
         else rng.normal(size=(1, s, k, cin)).astype(np.float32))
    wb = _stack(rng, cin, widths)
    emulated = _emulated_mlp_maxpool(torch.from_numpy(x), wb)
    torch.testing.assert_close(emulated, mlp_maxpool_plain(torch.from_numpy(x), wb), **MLP_TOL)
    ref = mlp_maxpool_pallas(jnp.asarray(x), tuple(jnp.asarray(w.numpy()) for w in wb[0]),
                             tuple(jnp.asarray(b.numpy()) for b in wb[1]))
    np.testing.assert_allclose(emulated.numpy(), np.asarray(ref), **MLP_TOL)


def test_a_folded_stack_is_laid_out_once_for_the_mlp():
    from pwclonet_pylidarslam_torch.models.layers import PointMLP

    mlp = PointMLP(6, (8, 8, 16), generator=torch.Generator().manual_seed(0))
    wb = mlp.folded()
    cpu = torch.device("cpu")
    packed = packed_fragments(wb, (6,), cpu)
    assert mlp.folded() is wb and packed_fragments(mlp.folded(), (6,), cpu) is packed
    assert torch.equal(packed, pack_fragments(*wb, (6,)))
    # refolded once a parameter is written: a new layout with it
    with torch.no_grad():
        mlp.scale_0.mul_(2.0)
    assert packed_fragments(mlp.folded(), (6,), cpu) is not packed


@pytest.mark.parametrize("widest,rows", [(8, 128), (16, 128), (64, 128), (65, 64), (128, 64)])
def test_max_tile_rows(widest, rows):
    """8 warps, each one 16-row tile and at most 8 n-tiles of a layer: a
    layer wider than 64 columns needs two warps a row tile."""
    assert max_tile_rows(widest) == rows


@pytest.mark.parametrize("centres,k,widest,expect", [
    # the path's calls at B=1
    (2048, 8, 128, (8, 64)),  # 16,384 rows: 64-row tiles, 256 blocks
    (1024, 8, 128, (8, 64)),  # 128 blocks
    (256, 8, 128, (2, 16)),  # 2,048 rows: below 32 x 132, so 16-row tiles
    (64, 16, 128, (1, 16)),  # one centre a block, 64 blocks
    (256, 16, 64, (2, 32)),
    (1024, 32, 32, (4, 128)),  # narrow: 128-row tiles
    (2048, 32, 16, (4, 128)),
    # a 128-wide layer gets at most 64 rows, a narrower one 128
    (100000, 8, 128, (8, 64)),
    (100000, 8, 64, (16, 128)),
    # a centre longer than the tile: one a block, taken in tiles of the most rows
    (5, 100, 128, (1, 64)),
    (3, 200, 16, (1, 128)),
    (2, 4096, 8, (1, 128)),
    # whole centres, padded to the mma tile
    (9999, 5, 33, (25, 128)),
    (7, 5, 5, (3, 16)),
    (1, 32, 8, (1, 32)),
])
def test_mlp_tile(centres, k, widest, expect):
    block, rows = mlp_tile(centres, k, widest, SMS)
    assert (block, rows) == expect
    assert rows % TILE_ROWS == 0 and TILE_ROWS <= rows <= max_tile_rows(widest)
    # a tile holds the block's centres whole, or a block is one centre longer than it
    assert block * k <= rows or block == 1
