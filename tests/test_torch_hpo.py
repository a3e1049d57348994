"""The port's HPO (``hpo/study.py``, ``hpo/objectives.py``,
``hpo/visualize.py``, ``cli/hpo.py``) against the JAX package on the CPU.

The study core is a copy: the same seed gives the same trials, parameters
and values as the JAX package's, exactly.  The three studies run end to end
on the synthetic data root of ``tests/conftest.py`` with a base-4 U-Net in
the registry (registered by the port, loaded by both packages from the same
file).  The preprocess study's scores equal JAX's within ``SCORE_TOL`` =
1e-6 (a mean of fp32 Dice differences; the masks themselves are compared
exactly where the two U-Nets' probabilities are not within 1e-5 of 0.5)."""

import json
import math

import numpy as np
import pytest
import torch

from samcarriestheburden_torch.cli import hpo as tcli
from samcarriestheburden_torch.config import UNetConfig
from samcarriestheburden_torch.hpo import objectives as tobj
from samcarriestheburden_torch.hpo import study as tstudy
from samcarriestheburden_torch.models.modelio import ModelRegistry
from samcarriestheburden_torch.models.unet import build_unet
from samcarriestheburden_tpu.hpo import objectives as jobj
from samcarriestheburden_tpu.hpo import study as jstudy

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

SCORE_TOL = 1e-6


def analytic(trial):
    x = trial.suggest_float("x", -3.0, 3.0)
    n = trial.suggest_int("n", 0, 6)
    c = trial.suggest_categorical("c", ["a", "b", None])
    lr = trial.suggest_float("lr", 1e-4, 1e-1, log=True)
    return -(x - 1.2) ** 2 - abs(n - 4) + (0.5 if c == "b" else 0.0) - abs(math.log10(lr) + 2)


def _trials(study):
    return [(t.number, t.params, t.value, t.state) for t in study.trials]


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_and_random_studies_draw_the_jax_trials(seed):
    for sampler in ("tpe", "random"):
        made = []
        for mod in (tstudy, jstudy):
            s = mod.create_study("maximize", "s", mod.TPESampler(n_startup_trials=5)
                                 if sampler == "tpe" else mod.RandomSampler(), seed)
            s.optimize(analytic, n_trials=25)
            made.append(s)
        assert _trials(made[0]) == _trials(made[1])
        assert made[0].best_params == made[1].best_params
    # the default sampler is TPE, as in JAX
    assert isinstance(tstudy.create_study().sampler, tstudy.TPESampler)


def test_grid_study_and_catch_against_jax():
    space = {"a": [1, 2, 3], "b": ["x", None], "c": [0.5, 1.5]}

    def objective(trial):
        a = trial.suggest_categorical("a", space["a"])
        b = trial.suggest_categorical("b", space["b"])
        c = trial.suggest_categorical("c", space["c"])
        extra = trial.suggest_int("extra", 0, 9)      # outside the grid: drawn
        if a == 2 and b is None:
            raise ValueError("a failed trial")
        return a * c - (b is None) + extra / 10

    made = []
    for mod in (tstudy, jstudy):
        s = mod.create_study("minimize", "g", mod.GridSampler(space), seed=1)
        s.optimize(objective, catch=(ValueError,))
        made.append(s)
    assert len(made[0].trials) == len(tstudy.GridSampler(space)) == 12
    assert _trials(made[0]) == _trials(made[1])
    assert sum(t.state == "failed" for t in made[0].trials) == 2
    assert made[0].best_value == made[1].best_value
    with pytest.raises(ValueError):
        tstudy.create_study(sampler=tstudy.GridSampler(space)).optimize(objective)


def test_persistence_across_the_packages(tmp_path):
    s = tstudy.create_study("maximize", "persist", seed=2)
    s.set_user_attr("model_id", "abc")
    s.optimize(analytic, n_trials=6)
    path = s.save(tmp_path / "port.json")
    loaded = jstudy.Study.load(path)
    assert loaded.study_name == "persist" and loaded.user_attrs == {"model_id": "abc"}
    assert _trials(loaded) == _trials(s) and loaded.best_value == s.best_value
    j = jstudy.create_study("minimize", "jax", seed=2)
    j.optimize(analytic, n_trials=4)
    back = tstudy.Study.load(j.save(tmp_path / "jax.json"))
    assert _trials(back) == _trials(j) and back.direction == "minimize"
    assert json.loads(path.read_text())["trials"][0]["state"] == "complete"


def test_visualize_study(tmp_path):
    from samcarriestheburden_torch.hpo.visualize import visualize_study

    s = tstudy.create_study("maximize")
    s.optimize(analytic, n_trials=6)
    figs = visualize_study(s.save(tmp_path / "s.json"), save_dir=tmp_path / "plots")
    assert set(figs) == {"history", "slice_x", "slice_n", "slice_c", "slice_lr"}
    for name in figs:
        assert (tmp_path / "plots" / f"{name}.png").exists()
    empty = tstudy.create_study()
    with pytest.raises(ValueError):
        visualize_study(empty.save(tmp_path / "e.json"))


# ---------------------------------------------------------------------------
# the three studies on the synthetic data root
# ---------------------------------------------------------------------------


def _register_tiny_unet(data_root):
    cfg = UNetConfig(n_channels=1, n_classes=17, base_channels=4, n_last_channel=4)
    return ModelRegistry(data_root / "model_registry").register(
        cfg, build_unet(cfg, device="cpu", seed=0))


def test_val_predictions_against_jax(data_root):
    mid = _register_tiny_unet(data_root)
    probs, gt, names = tobj.val_predictions(mid, str(data_root), "cpu")
    jprobs, jgt, jnames = jobj._val_predictions(mid, str(data_root))
    assert names == jnames == ["img003"]
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gt.numpy(), jgt)


def test_preprocess_study_against_jax(data_root):
    mid = _register_tiny_unet(data_root)
    objective, study = tobj.build_preprocess_study(mid, str(data_root), device="cpu")
    jobjective, jstudy_ = jobj.build_preprocess_study(mid, str(data_root))
    # a part of the grid: two elements, a radius that erodes, every selection
    part = {"structuring_element": ["disk", "star"], "radius": [3],
            "selection": ["largest", "highest_probability", None]}
    study.sampler, jstudy_.sampler = tstudy.GridSampler(part), jstudy.GridSampler(part)
    study.optimize(objective)
    jstudy_.optimize(jobjective)
    assert len(study.trials) == len(jstudy_.trials) == 6
    for t, j in zip(study.trials, jstudy_.trials):
        assert t.params == j.params and np.isfinite(t.value)
        assert abs(t.value - j.value) <= SCORE_TOL, (t.params, t.value, j.value)
    assert study.user_attrs == {"model_id": mid}


def test_sam_refine_study_end_to_end(data_root):
    from samcarriestheburden_torch.config import sam_vit_t_config
    from samcarriestheburden_torch.data.h5io import MemoryEmbeddings
    from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead
    from samcarriestheburden_torch.models.sam import build_sam

    mid = _register_tiny_unet(data_root)
    rng = np.random.default_rng(7)
    store = MemoryEmbeddings(128, {"img003": torch.from_numpy(
        rng.standard_normal((1, 16, 8, 8)).astype(np.float32))},
        {"img003": ((200, 120), (128, 77))}, checkpoint="tiny.npz")
    head = SamMaskDecoderHead(None, "vit_t", store, device="cpu",
                              params=build_sam(sam_vit_t_config(), device="cpu", seed=3))
    objective, study = tobj.build_sam_refine_study(mid, str(data_root), decoder_head=head,
                                                   device="cpu")
    study.optimize(objective, n_trials=1)
    assert [t.state for t in study.trials] == ["complete"]
    assert np.isfinite(study.best_value)
    assert {"prompts2use1st", "prompts2use2nd", "morph_op", "structuring_element",
            "radius"} <= set(study.trials[0].params)


def test_rndwalk_study_end_to_end(data_root):
    mid = _register_tiny_unet(data_root)
    objective, study = tobj.build_rndwalk_study(mid, str(data_root), device="cpu")
    study.optimize(objective, n_trials=1)
    assert [t.state for t in study.trials] == ["complete"]
    assert np.isfinite(study.best_value)
    # the JAX study with the same seed draws the same knobs in the same order
    _, jstudy_ = jobj.build_rndwalk_study(mid, str(data_root))
    jstudy_.optimize(lambda t: (t.suggest_int("background_erosion_radius", 1, 16),
                                t.suggest_float("laplace_sigma", 1, 20),
                                t.suggest_int("radius", 0, 16))[0], n_trials=1)
    assert jstudy_.trials[0].params == study.trials[0].params
    assert list(study.trials[0].params) == ["background_erosion_radius", "laplace_sigma",
                                            "radius"]


def test_cli_hpo_cpu(data_root, tmp_path, capsys):
    mid = _register_tiny_unet(data_root)
    tcli.main(["--study", "preprocess", "--model_id", mid, "--data_root", str(data_root),
               "--n_trials", "1", "--out_dir", str(tmp_path / "out"), "--cpu"])
    saved = tstudy.Study.load(tmp_path / "out" / "hpo_seg_preprocess.json")
    assert len(saved.trials) == 1 and saved.user_attrs["model_id"] == mid
    assert saved.trials[0].params == {"structuring_element": "square", "radius": 0,
                                      "selection": "largest"}
    assert "wrote" in capsys.readouterr().out
    assert tcli.OUTPUT_NAMES == {"preprocess": "hpo_seg_preprocess.json",
                                 "sam_refine": "grid_search_sam_refine.json",
                                 "rndwalk": "hpo_rnd_wlk_refine.json"}
