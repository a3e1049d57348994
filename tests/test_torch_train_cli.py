"""The port's training CLIs (``cli/train.py``, ``cli/train_on_pseudo_labels.py``)
and data CLIs on the CPU, against the JAX package: a model the port trains
is registered in the JAX schema and gives the JAX U-Net's logits there, and
each data CLI writes the same files as its JAX counterpart from the same
arguments."""

import contextlib
import filecmp
import importlib
import io
import json
import shutil
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from samcarriestheburden_torch import config as tconfig
from samcarriestheburden_torch.data.h5io import MaskWriter
from samcarriestheburden_torch.models.modelio import ModelRegistry
from samcarriestheburden_tpu.models import unet as junet
from samcarriestheburden_tpu.models.modelio import ModelRegistry as JModelRegistry

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

#: fp32 logits of the same weights in both packages: another order of summation
LOGIT_TOL = 1e-4
NEW_CLIS = ["train", "train_on_pseudo_labels", "make_synthetic_dataset",
            "define_successively_data_subsets", "copy_and_process_imgs",
            "import_reference_data", "sanity_check_saved_segmentation"]


def port_cli(name):
    return importlib.import_module(f"samcarriestheburden_torch.cli.{name}")


def jax_cli(name):
    return importlib.import_module(f"samcarriestheburden_tpu.cli.{name}")


def same_tree(a: Path, b: Path):
    """Both directory trees hold the same files with the same bytes."""
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files_a == files_b and files_a
    for rel in files_a:
        assert filecmp.cmp(a / rel, b / rel, shallow=False), rel


@pytest.mark.parametrize("name", NEW_CLIS)
def test_cli_help(name):
    buf = io.StringIO()
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stdout(buf):
        port_cli(name).main(["--help"])
    assert exc.value.code == 0 and "usage" in buf.getvalue().lower()


@pytest.fixture
def in_data_root(data_root, monkeypatch):
    """The conftest's data root as the working directory, and the CLIs' U-Net
    at base 4 (they train ``UNetConfig()``'s width, base 64, otherwise)."""
    monkeypatch.chdir(data_root.parent)
    monkeypatch.setattr(tconfig, "UNetConfig", partial(tconfig.UNetConfig, base_channels=4))
    return data_root


def jax_logits_equal_the_port(data_root, model_id):
    """The registered model in the JAX registry against the port's load of it."""
    jcfg, params = JModelRegistry(data_root / "model_registry").load(model_id)
    cfg, model = ModelRegistry(data_root / "model_registry").load(model_id, device="cpu")
    assert cfg.to_json() == jcfg.to_json()
    x = np.random.default_rng(0).standard_normal((1, 1, 48, 32)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(junet.apply(params, jcfg, x)), atol=LOGIT_TOL,
                               rtol=0)
    return jcfg


def test_train_then_train_on_pseudo_labels(in_data_root):
    model_id = port_cli("train").main([
        "--cpu", "--epochs", "2", "--data_sample_per_epoch", "4", "--batch_size", "2",
        "--n_last_channel", "4", "--data_aug", "0.03", "--profile", "runs/prof_test"])
    assert isinstance(model_id, str) and len(model_id) == 32
    assert (in_data_root / "model_registry" / model_id / "model.npz").exists()
    phases = json.loads(Path("runs/prof_test/phases.json").read_text())
    assert phases["train_unet.epoch"]["count"] == 2 and phases["train_unet.evaluate"]["count"] == 2
    run = next(Path("runs").glob("Kids Bone Checker_Bone segmentation_fewer samples/*"))
    scalars = [json.loads(line) for line in (run / "scalars.jsonl").read_text().splitlines()]
    assert {s["title"] for s in scalars} == {"BCE", "Dice", "Learning rate"}
    jcfg = jax_logits_equal_the_port(in_data_root, model_id)
    assert jcfg.base_channels == 4 and jcfg.n_last_channel == 4

    # f_phi: fine-tuned from that model on its raw pseudo labels (the 500 split)
    rng = np.random.default_rng(1)
    with MaskWriter(in_data_root / "seg_masks" / model_id / "raw_segmentations_500.h5") as w:
        w.write("img005", (rng.random((17, 384, 224)) > 0.8).astype(np.uint8))
    final_id = port_cli("train_on_pseudo_labels").main([
        "--cpu", "--pseudo_label", "raw", "--pseudo_label_suffix", "500", "--model_id",
        model_id, "--no-train_from_scratch", "--epochs", "2", "--batch_size", "1",
        "--data_aug", "0"])
    assert final_id != model_id
    meta = json.loads((in_data_root / "model_registry" / final_id / "meta.json").read_text())
    assert meta["initial_model"] == model_id and meta["task"] == "raw_num_train_43"
    jax_logits_equal_the_port(in_data_root, final_id)


def test_the_training_clis_refuse_what_is_not_ported(in_data_root):
    """In one process: more devices than processes (one card per process),
    ``--multihost`` with no group to join, a sharded split over two devices."""
    with pytest.raises(ValueError, match="nproc-per-node 2"):
        port_cli("train").main(["--cpu", "--num_devices", "2"])
    with pytest.raises(ValueError, match="torchrun"):
        port_cli("train").main(["--cpu", "--multihost"])
    with pytest.raises(ValueError, match="one card per process"):
        port_cli("train").main(["--cpu", "--epochs", "1", "--data_placement", "sharded",
                                "--num_devices", "2"])


def test_pseudo_label_paths_match_jax():
    ours, theirs = port_cli("train_on_pseudo_labels"), jax_cli("train_on_pseudo_labels")
    for label in ("raw", "sam", "nnunet", "rndwalk"):
        args = ("data", "m1", label, ["box"], ["pos_points", "neg_points"], "500")
        assert ours.pseudo_label_path(*args) == theirs.pseudo_label_path(*args)
    with pytest.raises(ValueError):
        ours.pseudo_label_path("data", "m1", "other", None, None)


SYNTH_ARGS = ["--n_train1", "2", "--n_train2", "1", "--n_val", "1", "--n_test", "1",
              "--n_unlabeled", "2", "--height", "96", "--width", "64", "--seed", "3",
              "--unlabeled_gt_xml"]


def test_make_synthetic_dataset_writes_the_jax_files(tmp_path):
    port_cli("make_synthetic_dataset").main(["--data_root", str(tmp_path / "port")] + SYNTH_ARGS)
    jax_cli("make_synthetic_dataset").main(["--data_root", str(tmp_path / "jax")] + SYNTH_ARGS)
    same_tree(tmp_path / "port", tmp_path / "jax")


def test_define_successively_data_subsets_writes_the_jax_file(tmp_path, data_root):
    port_cli("make_synthetic_dataset").main(["--data_root", str(tmp_path / "port")] + SYNTH_ARGS)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    for root in ("port", "jax"):
        (tmp_path / root / "successively_training_files_order.csv").unlink()
    port_cli("define_successively_data_subsets").main(["--data_root", str(tmp_path / "port"),
                                                       "--selected_index", "1"])
    jax_cli("define_successively_data_subsets").main(["--data_root", str(tmp_path / "jax"),
                                                      "--selected_index", "1"])
    same_tree(tmp_path / "port", tmp_path / "jax")
    # the conftest's annotations cover 2 of 17 classes: both refuse
    for cli in (port_cli, jax_cli):
        with pytest.raises(AssertionError, match="all classes"):
            cli("define_successively_data_subsets").main(["--data_root", str(data_root)])


def test_copy_and_process_imgs_writes_the_jax_files(tmp_path, data_root):
    src = data_root / "img_only_front_all_left"
    for root in ("port", "jax"):
        cli = port_cli if root == "port" else jax_cli
        cli("copy_and_process_imgs").main(["--src", str(src), "--dst", str(tmp_path / root),
                                           "--data_root", str(data_root)])
    same_tree(tmp_path / "port", tmp_path / "jax")
    import cv2
    flipped = cv2.imread(str(tmp_path / "port" / "img001.png"), cv2.IMREAD_GRAYSCALE)
    assert np.array_equal(flipped, cv2.imread(str(src / "img001.png"),
                                              cv2.IMREAD_GRAYSCALE)[:, ::-1])


def test_import_reference_data_writes_the_jax_files(tmp_path):
    """On a reference checkout's data conventions, built here: the two split
    CSVs and the four CVAT XMLs (from the synthetic generator)."""
    import pandas as pd

    ref = tmp_path / "reference"
    port_cli("make_synthetic_dataset").main(["--data_root", str(ref / "data")] + SYNTH_ARGS)
    pd.DataFrame({"filestem": [f"s{i:03d}" for i in range(500)]}).to_csv(
        ref / "data" / "500unlabeled_sample.csv")
    for root in ("port", "jax"):
        cli = port_cli if root == "port" else jax_cli
        out = cli("import_reference_data").main(["--reference_root", str(ref),
                                                 "--data_root", str(tmp_path / root)])
        assert out == tmp_path / root
    same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(list((tmp_path / "port" / "cvat_annotation_xml").glob("*.xml"))) == 4


def test_sanity_check_saved_segmentation_writes_the_jax_figures(tmp_path, data_root):
    import cv2
    import matplotlib

    matplotlib.use("Agg")
    h5 = tmp_path / "seg.h5"
    masks = np.zeros((17, 384, 224), np.uint8)
    masks[3, 100:150, 50:90] = 1
    masks[9, 200:260, 120:200] = 1
    with MaskWriter(h5) as w:
        w.write("img005", masks, estimated_dice=np.linspace(0, 1, 17, dtype=np.float32))
    for root in ("port", "jax"):
        cli = port_cli if root == "port" else jax_cli
        cli("sanity_check_saved_segmentation").main([
            "--h5", str(h5), "--data_root", str(data_root), "--stem", "img005",
            "--save_dir", str(tmp_path / root)])
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(names) == 2
    for name in names:
        assert np.array_equal(cv2.imread(str(tmp_path / "port" / name)),
                              cv2.imread(str(tmp_path / "jax" / name)))
