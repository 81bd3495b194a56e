"""The port's headless visualization against the reference's: the viz part of
``tests/test_viz_distributed.py`` (``evaluation/viz.py``: the same numpy, so
the arrays are bit-equal), ``player.html`` (byte for byte the reference's for
the same inputs) and the gallery (``evaluation/gallery.py``), whose vertex
maps come from the port's projector: the share of pixels whose vertex
differs from the reference's is held under 1e-3, and so is the share of
differing pixels of the images written. Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.evaluation import gallery as tgallery
from pwclonet_pylidarslam_torch.evaluation import player as tplayer
from pwclonet_pylidarslam_torch.evaluation import viz as tviz
from pwclonet_pylidarslam_tpu.evaluation import gallery as jgallery
from pwclonet_pylidarslam_tpu.evaluation import player as jplayer
from pwclonet_pylidarslam_tpu.evaluation import viz as jviz

PIXEL_SHARE = 1e-3  # of a vertex map's pixels that may differ from the reference's


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    """Six scans of 4096 points in a box around the sensor and a curving
    trajectory (float32 scans, float64 poses)."""
    rng = np.random.default_rng(4)
    scans = []
    for _ in range(6):
        d = rng.normal(size=(4096, 3))
        d[:, 2] = np.abs(d[:, 2]) * -0.3
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        scans.append((d * rng.uniform(2.0, 40.0, (4096, 1))).astype(np.float32))
    poses = np.tile(np.eye(4), (6, 1, 1))
    for t in range(6):
        c, s = np.cos(0.1 * t), np.sin(0.1 * t)
        poses[t, :2, :2] = [[c, -s], [s, c]]
        poses[t, :3, 3] = [1.5 * t, 0.1 * t * t, 0.0]
    return scans, poses


def test_colorize(rng):
    vals = rng.normal(size=(32, 64))
    img = tviz.colorize(vals)
    assert img.shape == (32, 64, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, jviz.colorize(vals))
    np.testing.assert_array_equal(tviz.colorize(vals, "magma", -1.0, 1.0),
                                  jviz.colorize(vals, "magma", -1.0, 1.0))


def test_vertex_map_image(rng):
    vm = np.zeros((16, 32, 3), np.float32)
    vm[4:12, 8:24] = rng.uniform(5, 30, size=(8, 16, 3))
    img = tviz.vertex_map_image(vm)
    assert img.shape == (16, 32, 3) and np.all(img[0, 0] == 0) and img[8, 16].sum() > 0
    np.testing.assert_array_equal(img, jviz.vertex_map_image(vm))
    np.testing.assert_array_equal(tviz.vertex_map_image(vm, "height"),
                                  jviz.vertex_map_image(vm, "height"))
    with pytest.raises(ValueError):
        tviz.vertex_map_image(vm, "intensity")


def test_bev_image_and_save(rng, tmp_path):
    import matplotlib.pyplot as plt

    pts = rng.uniform(-20, 20, size=(2000, 3)).astype(np.float32)
    img = tviz.bev_image(pts, pixel_size=0.5, size=128)
    assert img.shape == (128, 128, 3) and img.sum() > 0
    np.testing.assert_array_equal(img, jviz.bev_image(pts, pixel_size=0.5, size=128))
    tviz.save_image(str(tmp_path / "bev.png"), img)
    np.testing.assert_array_equal((plt.imread(tmp_path / "bev.png")[..., :3] * 255).round(), img)


def test_player_is_the_references_byte_for_byte(run, tmp_path):
    scans, poses = run
    port = tplayer.write_run_player(str(tmp_path / "port"), "seq", scans, poses, poses,
                                    points_per_frame=512)
    ref = jplayer.write_run_player(str(tmp_path / "ref"), "seq", scans, poses, poses,
                                   points_per_frame=512)
    page = open(port, "rb").read()
    assert page == open(ref, "rb").read()
    assert b'"frames":' in page and b"<canvas" in page
    without_gt = tplayer.write_run_player(str(tmp_path / "port1"), "s", scans, poses)
    assert open(without_gt, "rb").read() == open(jplayer.write_run_player(
        str(tmp_path / "ref1"), "s", scans, poses), "rb").read()


def test_gallery_vertex_maps_and_pages(run, tmp_path):
    """The port's gallery on the CPU beside the reference's: the same pages,
    plots and frames; each vertex map within ``PIXEL_SHARE`` of differing
    pixels of the reference projector's, each image too."""
    import jax.numpy as jnp
    import matplotlib.pyplot as plt

    from pwclonet_pylidarslam_torch.core.projection import density_matched_projector
    from pwclonet_pylidarslam_tpu.core.projection import density_matched_projector as jdmp

    scans, poses = run
    metrics = {"ATE": 0.25, "tr_err": 1.5, "name": "skipped", "nan": float("nan")}
    port = tgallery.write_run_gallery(str(tmp_path / "port"), "seq", scans, poses, poses,
                                      max_frames=3, metrics=metrics, device="cpu")
    ref = jgallery.write_run_gallery(str(tmp_path / "ref"), "seq", scans, poses, poses,
                                     max_frames=3, metrics=metrics)
    assert open(port).read() == open(ref).read()
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == ["frame_000000_bev.png", "frame_000000_vm.png", "frame_000002_bev.png",
                     "frame_000002_vm.png", "frame_000005_bev.png", "frame_000005_vm.png",
                     "index.html", "path_2d.png", "path_3d.png", "rpy.png", "xyz.png"]
    proj, jproj = density_matched_projector(4096), jdmp(4096)
    for i in (0, 2, 5):
        vm = tgallery.vertex_map(proj, scans[i], "cpu")
        ref_vm = np.asarray(jproj.build_projection_map(jnp.asarray(scans[i][None]))[0])
        assert vm.shape == ref_vm.shape == (64, 512, 3)
        assert np.any(vm != ref_vm, axis=-1).mean() <= PIXEL_SHARE
        for kind in ("vm", "bev"):
            a = plt.imread(tmp_path / "port" / f"frame_{i:06d}_{kind}.png")
            b = plt.imread(tmp_path / "ref" / f"frame_{i:06d}_{kind}.png")
            assert np.any(a != b, axis=-1).mean() <= PIXEL_SHARE
