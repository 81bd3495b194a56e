"""Port parity: the shape datasets and augmentations of
``pwclonet_pylidarslam_torch/data/shapes.py`` against the reference's
``pwclonet_pylidarslam_tpu/data/shapes.py``. Both are numpy: under one
``numpy.random.Generator`` state every function must give the reference's
arrays to the bit, and the readers must read the upstream formats (a
ModelNet40 CSV tree, an Indoor3D hdf5 bundle) into the same items."""

import os

import numpy as np
import pytest

from pwclonet_pylidarslam_torch.data import shapes as tshapes
from pwclonet_pylidarslam_tpu.data import shapes as jshapes


def _pair(seed: int = 7):
    """Two generators in the same state, one for each side."""
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _assert_same(a, b):
    np.testing.assert_array_equal(a, b)
    assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("width", [3, 6])
@pytest.mark.parametrize("fn", [
    "scale_points", "rotate_points_random", "rotate_perturbation", "jitter_points",
    "translate_points", "random_input_dropout", "augment_cls",
])
def test_augmentations_bit_equal(fn, width):
    pts = np.random.default_rng(1).normal(size=(200, width)).astype(np.float32)
    r1, r2 = _pair()
    out = getattr(tshapes, fn)(pts, r1)
    _assert_same(out, getattr(jshapes, fn)(pts, r2))
    assert r1.random() == r2.random()  # the same draws were taken
    assert out is not pts


def test_geometry_helpers_bit_equal():
    pts = np.random.default_rng(2).normal(size=(64, 6)).astype(np.float32)
    _assert_same(tshapes.pc_normalize(pts[:, :3]), jshapes.pc_normalize(pts[:, :3]))
    _assert_same(tshapes.angle_axis(0.7, np.array([1.0, 2.0, -0.5])),
                 jshapes.angle_axis(0.7, np.array([1.0, 2.0, -0.5])))
    _assert_same(tshapes.rotate_points(pts, 1.1, (0.0, 0.0, 1.0)),
                 jshapes.rotate_points(pts, 1.1, (0.0, 0.0, 1.0)))


@pytest.mark.parametrize("kind", list(jshapes.SHAPE_CLASSES))
def test_sample_shape_bit_equal(kind):
    r1, r2 = _pair(3)
    _assert_same(tshapes._sample_shape(kind, 257, r1), jshapes._sample_shape(kind, 257, r2))


def test_synthetic_sets_bit_equal():
    assert tshapes.SHAPE_CLASSES == jshapes.SHAPE_CLASSES
    ours, theirs = tshapes.SyntheticShapes(13, 96, seed=4), jshapes.SyntheticShapes(13, 96, seed=4)
    assert len(ours) == len(theirs) and ours.classes == theirs.classes
    for i in range(len(ours)):
        (p, l), (q, m) = ours[i], theirs[i]
        _assert_same(p, q)
        assert l == m
    ours, theirs = tshapes.SyntheticRooms(5, 130, seed=2), jshapes.SyntheticRooms(5, 130, seed=2)
    assert ours.num_classes == theirs.num_classes
    for i in range(len(ours)):
        for a, b in zip(ours[i], theirs[i]):
            _assert_same(a, b)


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_batches_bit_equal(augment, shuffle, drop_last):
    r1, r2 = _pair(5)
    got = list(tshapes.batches(tshapes.SyntheticShapes(10, 64), 4, r1, shuffle=shuffle,
                               augment=augment, drop_last=drop_last))
    want = list(jshapes.batches(jshapes.SyntheticShapes(10, 64), 4, r2, shuffle=shuffle,
                                augment=augment, drop_last=drop_last))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            _assert_same(a[key], b[key])
    # segmentation items (per-point labels) are never augmented
    rooms = list(tshapes.batches(tshapes.SyntheticRooms(4, 64), 2, r1, augment=augment))
    assert rooms[0]["points"].shape == (2, 64, 9) and rooms[0]["labels"].shape == (2, 64)


def _write_modelnet(root, rng, points_per_shape=64):
    classes = ["airplane", "chair"]
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(classes) + "\n")
    ids = {"train": [], "test": []}
    for c in classes:
        os.makedirs(os.path.join(root, c))
        for i in range(3):
            sid = f"{c}_{i:04d}"
            pts = rng.normal(size=(points_per_shape, 6)).astype(np.float32)
            np.savetxt(os.path.join(root, c, sid + ".txt"), pts, delimiter=",")
            ids["train" if i < 2 else "test"].append(sid)
    for split, names in ids.items():
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")


@pytest.mark.parametrize("train,num_points,use_normals", [
    (True, 32, False), (False, 128, True), (False, 16, False)])
def test_modelnet40_reader_matches_reference(tmp_path, train, num_points, use_normals):
    _write_modelnet(str(tmp_path), np.random.default_rng(0))
    kw = dict(num_points=num_points, train=train, use_normals=use_normals, seed=3)
    ours = tshapes.ModelNet40Dataset(str(tmp_path), **kw)
    theirs = jshapes.ModelNet40Dataset(str(tmp_path), **kw)
    assert len(ours) == len(theirs) == (4 if train else 2)
    assert ours.classes == theirs.classes == ["airplane", "chair"]
    for i in list(range(len(ours))) * 2:  # twice: the train split draws anew, the cache serves
        (p, l), (q, m) = ours[i], theirs[i]
        _assert_same(p, q)
        assert l == m
    assert p.shape == (num_points, 6 if use_normals else 3)


def test_indoor3d_reader_matches_reference(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    with h5py.File(tmp_path / "ply_data_all_0.h5", "w") as f:
        f.create_dataset("data", data=rng.normal(size=(6, 64, 9)).astype(np.float32))
        f.create_dataset("label", data=rng.integers(0, 13, size=(6, 64)).astype(np.int32))
    (tmp_path / "all_files.txt").write_text("indoor3d_sem_seg_hdf5_data/ply_data_all_0.h5\n")
    (tmp_path / "room_filelist.txt").write_text(
        "\n".join(["Area_1_office_1"] * 4 + ["Area_5_office_1"] * 2) + "\n")
    for train in (True, False):
        ours = tshapes.Indoor3DSemSegDataset(str(tmp_path), num_points=32, train=train, seed=1)
        theirs = jshapes.Indoor3DSemSegDataset(str(tmp_path), num_points=32, train=train, seed=1)
        assert len(ours) == len(theirs) == (4 if train else 2)
        assert ours.NUM_CLASSES == theirs.NUM_CLASSES == 13
        for i in range(len(ours)):
            for a, b in zip(ours[i], theirs[i]):
                _assert_same(a, b)
