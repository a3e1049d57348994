"""The port's CLIs in two real gloo processes against one process of the same
CLIs (``samcarriestheburden_torch/parallel/worker.py``'s ``cli`` job, as
``tests/test_multihost.py`` runs the JAX CLIs): ``generate_img_embeddings``
through its own ``--multihost`` flags, then ``--merge_shards``;
``save_refined_segmentations`` with each refiner (part files, merged with
``merge_mask_shards``); ``amg`` (strided images).  Every artifact is the
single process's, bit for bit.  The random-walk sweep is also held against
``RndWalkSegRefiner`` called directly, and its file name and attributes
against the JAX CLI's."""

import json
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from samcarriestheburden_torch.cli.save_segmentations import read_unet_image
from samcarriestheburden_torch.config import UNetConfig as TorchUNetConfig
from samcarriestheburden_torch.data import h5io as th5
from samcarriestheburden_torch.engine.refinement import RndWalkSegRefiner, SegEnhance
from samcarriestheburden_torch.models import convert as tconvert
from samcarriestheburden_torch.models.modelio import ModelRegistry as TorchRegistry
from samcarriestheburden_torch.models.unet import build_unet, unet_probabilities
from samcarriestheburden_torch.parallel.dryrun import run_workers
from samcarriestheburden_tpu.cli import save_refined_segmentations as j_refine
from samcarriestheburden_tpu.config import UNetConfig, sam_vit_t_config
from samcarriestheburden_tpu.engine import refinement as j_refinement
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import modelio as jmodelio

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
UNET_CFG = dict(n_channels=1, n_classes=17, base_channels=4, n_last_channel=4)
STEMS = ["img002", "img003", "img005"]
SAM_NAME = "sam_box_refine_pos_points_neg_points_500.h5"
RW_NAME = "rndwalk_500.h5"
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One data root, copied for a one-process and a two-process run of the
    ``cli`` job, run at the same time."""
    import conftest
    import cv2

    base = tmp_path_factory.mktemp("cli")
    root = conftest.data_root.__wrapped__(base / "src")     # the conftest layout
    pd.DataFrame({"filestem": STEMS}).to_csv(root / "500unlabeled_sample.csv")
    cfg = TorchUNetConfig(**UNET_CFG)
    params = tconvert.unet_params_from_torch(build_unet(cfg, device="cpu", seed=0).state_dict(),
                                             cfg)
    params["outc"] = {"w": params["outc"]["w"] * 3, "b": np.full((17,), -3.0, np.float32)}
    model_id = jmodelio.ModelRegistry(root / "model_registry").register(
        UNetConfig(**UNET_CFG), params, name="theta")
    gold = np.load(GOLDEN / "sam_e2e.npz")
    sd = {k[3:]: gold[k] for k in gold.files if k.startswith("sd/")}
    jmodelio.save_params(root / "tiny.npz", jconvert.sam_params_from_torch(sd, sam_vit_t_config()))
    (root / "amg_in").mkdir()
    for s in ("img000", "img001"):
        img = cv2.imread(str(root / "img_only_front_all_left" / f"{s}.png"), cv2.IMREAD_GRAYSCALE)
        cv2.imwrite(str(root / "amg_in" / f"{s}.png"), img)
    dirs = {}
    for tag in ("single", "mh"):
        dirs[tag] = base / tag
        shutil.copytree(root, dirs[tag] / "data")
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(run_workers, "cli", n, timeout=TIMEOUT_S,
                            spec=dict(root=str(dirs[tag]), model_id=model_id, tag=tag))
                for tag, n in (("single", 1), ("mh", 2))]
        recs = [f.result() for f in futs]
    assert [len(r) for r in recs] == [1, 2] and all(len(r) == 1 for rs in recs for r in rs)
    return dirs, model_id


def _embeddings(path):
    with th5.EmbeddingReader(path) as r:
        return {s: (r.features(s), *r.sizes(s)) for s in r.stems()}


def _masks(path):
    with th5.MaskReader(path) as r:
        return {s: (r.masks(s), r.estimated_dice(s)) for s in r.stems()}, dict(r.f.attrs)


def test_two_process_embeddings_equal_one_process(cli_runs):
    dirs, _ = cli_runs
    one = _embeddings(dirs["single"] / "data" / "emb_single.h5")
    two = _embeddings(dirs["mh"] / "data" / "emb_mh.h5")
    assert sorted(one) == sorted(two) and len(one) == 6
    for s, (f, orig, inp) in one.items():
        np.testing.assert_array_equal(two[s][0], f)
        np.testing.assert_array_equal(two[s][1], orig)
        np.testing.assert_array_equal(two[s][2], inp)
    # the parts stay beside the merged file, each with its provenance
    for p in range(2):
        with h5py.File(dirs["mh"] / "data" / f"emb_mh.h5.part{p}", "r") as f:
            assert f.attrs["shard_count"] == 2
            assert sorted(f["img_embedding"]) == sorted(one)[p::2]


@pytest.mark.parametrize("name", [SAM_NAME, RW_NAME])
def test_two_process_sweep_equals_one_process(cli_runs, tmp_path, name):
    dirs, model_id = cli_runs
    one, attrs = _masks(dirs["single"] / "data" / "seg_masks" / model_id / name)
    assert sorted(one) == STEMS and "shard_count" not in attrs
    out = dirs["mh"] / "data" / "seg_masks" / model_id / name
    for p in range(2):
        part = tmp_path / f"{name}.part{p}"
        shutil.copy(f"{out}.part{p}", part)
        with h5py.File(part, "r") as f:
            assert f.attrs["shard_count"] == 2
            assert sorted(f["segmentation_mask"]) == STEMS[p::2]
    two, two_attrs = _masks(th5.merge_mask_shards(tmp_path / name))
    assert sorted(two) == STEMS
    assert two_attrs == attrs
    for s, (m, est) in one.items():
        np.testing.assert_array_equal(two[s][0], m)
        np.testing.assert_array_equal(two[s][1], est)
    if name == RW_NAME:
        assert all(np.isnan(est).all() for _, est in one.values())
    else:
        assert any(np.isfinite(est).any() for _, est in one.values())


def test_two_process_amg_equals_one_process(cli_runs):
    dirs, _ = cli_runs
    single = sorted((dirs["single"] / "out_amg_single").iterdir())
    assert [d.name for d in single] == ["img000", "img001"]
    for img_dir in single:
        mh_dir = dirs["mh"] / "out_amg_mh" / img_dir.name
        names = sorted(f.name for f in img_dir.iterdir())
        assert names and names == sorted(f.name for f in mh_dir.iterdir())
        for f in names:
            assert (img_dir / f).read_bytes() == (mh_dir / f).read_bytes(), f


def test_the_rndwalk_sweep_is_the_refiner_called_directly(cli_runs, monkeypatch):
    """``--refiner rndwalk --cpu`` wrote, image by image, what ``SegEnhance``
    over ``RndWalkSegRefiner`` gives on the U-Net's probabilities, with a NaN
    Dice row; its file name and attribute keys (and ``refine_params``) are
    the JAX CLI's, run in a copy of the data root with its random walk
    stubbed (the names and attributes are the CLI's; the walk's masks are
    held above)."""
    dirs, model_id = cli_runs
    root = dirs["single"] / "data"
    got, attrs = _masks(root / "seg_masks" / model_id / RW_NAME)
    _, unet = TorchRegistry(root / "model_registry").load(model_id, "cpu")
    img_dir = root / "img_only_front_all_left"
    enh = SegEnhance(RndWalkSegRefiner(8, 5.0, img_path=img_dir, device="cpu"),
                     "highest_probability", "dilation", "square", 8)
    for s in STEMS:
        probs = unet_probabilities(unet, torch.from_numpy(read_unet_image(img_dir, s)[None]))
        refined, est = enh.enhance(probs[0], s)
        assert est is None
        np.testing.assert_array_equal(got[s][0], refined.numpy().astype(np.uint8))
        assert got[s][1].shape == (17,) and np.isnan(got[s][1]).all()
    jroot = dirs["single"] / "jax"
    shutil.copytree(root, jroot / "data", ignore=shutil.ignore_patterns("seg_masks", "emb_*"))
    monkeypatch.chdir(jroot)
    monkeypatch.setattr(j_refinement.RndWalkSegRefiner, "refine",
                        lambda self, seg, file_name: (seg > 0.5, None))
    j_refine.main(["--model_id", model_id, "--n_files", "500", "--refiner", "rndwalk", "--cpu",
                   "--img_batch", "1"])
    jpath = jroot / "data" / "seg_masks" / model_id / RW_NAME
    assert jpath.exists()
    with h5py.File(jpath, "r") as f:
        jattrs = dict(f.attrs)
        assert sorted(f["segmentation_mask"]) == STEMS
    assert sorted(jattrs) == sorted(attrs)
    assert json.loads(jattrs["refine_params"]) == json.loads(attrs["refine_params"])
    assert jattrs["model_id"] == attrs["model_id"] == model_id
