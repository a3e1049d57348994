"""The port's GrazPedWri datasets (``samcarriestheburden_torch/data/datasets.py``)
against the JAX package's on the conftest's synthetic data root: the same
arrays, stems and order from the same files."""

import random

import numpy as np
import pytest
import torch

from samcarriestheburden_torch.config import N_CLASSES
from samcarriestheburden_torch.data import datasets as tds
from samcarriestheburden_torch.data.h5io import MaskWriter
from samcarriestheburden_tpu.data import datasets as jds

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)


def assert_same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        for u, v in zip(a[i], b[i]):
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


def write_masks(path, stems, seed=0, hw=(200, 120)):
    """Seeded (17, H, W) uint8 masks, in the schema both packages read."""
    rng = np.random.default_rng(seed)
    with MaskWriter(path) as w:
        for stem in stems:
            w.write(stem, (rng.random((N_CLASSES, *hw)) > 0.7).astype(np.uint8),
                    estimated_dice=rng.random(N_CLASSES).astype(np.float32))
    return path


@pytest.mark.parametrize("mode, n", [("train", "all"), ("train", 2), ("val", "all")])
def test_light_dataset_matches_jax(data_root, mode, n):
    ours = tds.LightSegGrazPedWriDataset(mode, n, data_root=str(data_root))
    theirs = jds.LightSegGrazPedWriDataset(mode, n, data_root=str(data_root))
    assert ours.available_file_names == theirs.available_file_names
    x, y, stems = ours.as_arrays()
    jx, jy, jstems = theirs.as_arrays()
    assert stems == jstems and x.dtype == jx.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.shape[1:] == (1, 384, 224) and y.shape[1:] == (N_CLASSES, 384, 224)
    assert y.any()


@pytest.mark.parametrize("split500", [True, False])
def test_saved_dataset_matches_jax(data_root, tmp_path, split500):
    h5 = write_masks(tmp_path / "seg.h5", ["img005", "img003"])
    ours = tds.SavedSegGrazPedWriDataset(h5, split500, data_root=str(data_root))
    theirs = jds.SavedSegGrazPedWriDataset(h5, split500, data_root=str(data_root))
    assert ours.available_file_names == theirs.available_file_names \
        == (["img005"] if split500 else ["img003", "img005"])
    for a, b in zip(ours.as_arrays(), theirs.as_arrays()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_combined_dataset_matches_jax(data_root, tmp_path):
    h5 = write_masks(tmp_path / "seg.h5", ["img005", "img003", "img002"])
    ours = tds.CombinedSegGrazPedWriDataset(
        tds.LightSegGrazPedWriDataset("train", data_root=str(data_root)),
        tds.SavedSegGrazPedWriDataset(h5, False, data_root=str(data_root)))
    theirs = jds.CombinedSegGrazPedWriDataset(
        jds.LightSegGrazPedWriDataset("train", data_root=str(data_root)),
        jds.SavedSegGrazPedWriDataset(h5, False, data_root=str(data_root)))
    assert len(ours) == len(theirs) == 3
    for i in range(len(ours)):
        random.seed(i)
        a = ours[i]
        random.seed(i)
        b = theirs[i]
        assert_same_items([a["gt"], a["pseudo_lbl"]], [b["gt"], b["pseudo_lbl"]])


@pytest.mark.parametrize("pseudo", [False, True])
def test_mean_teacher_dataset_matches_jax(data_root, pseudo):
    kw = {}
    if pseudo:
        write_masks(data_root / "seg_masks" / "m0" / "selected_pseudo_labels_500_dsc_09.h5",
                    ["img005"])
        kw = dict(model_id_pseudo_label="m0", dsc_agreement_threshold=0.9)
    ours = tds.MeanTeacherSegGrazPedWriDataset(True, data_root=str(data_root), **kw)
    theirs = jds.MeanTeacherSegGrazPedWriDataset(True, data_root=str(data_root), **kw)
    assert ours.available_file_names == theirs.available_file_names \
        == ["img000", "img001", "img002", "img005"]
    assert ours.use_pseudo_label == theirs.use_pseudo_label == pseudo
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a[2] == b[2]
        np.testing.assert_array_equal(a[0], b[0])
        assert (a[1] is None) == (b[1] is None) == (a[2] == "img005" and not pseudo)
        if a[1] is not None:
            np.testing.assert_array_equal(a[1], b[1])


def test_unknown_mode_and_missing_pseudo_labels_refused(data_root):
    with pytest.raises(ValueError, match="Unknown mode"):
        tds.LightSegGrazPedWriDataset("trian", data_root=str(data_root))
    with pytest.raises(AssertionError, match="Pseudo label file does not exist"):
        tds.MeanTeacherSegGrazPedWriDataset(True, model_id_pseudo_label="nope",
                                            dsc_agreement_threshold=0.9,
                                            data_root=str(data_root))
