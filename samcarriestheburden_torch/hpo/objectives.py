"""The three reference HPO studies (JAX ``hpo/objectives.py``, reference
seg_processing/hpo_*.py), on the port's refinement engine and its copy of
the optuna-compatible study core.

Each ``build_*_study`` returns (objective, study); ``cli/hpo.py`` runs them.  Every
objective has the reference's score: the mean over the validation split of
(Dice_refined - Dice_baseline), NaN-aware (hpo_bce_unet_sam_postprocess.py:
51-57).  The U-Net's probabilities, the refinement and the Dice stay on
``device`` (None: the card; raises without one); the data loads on the host
(``data/datasets.py``: cv2, pandas, imported there).
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch

from samcarriestheburden_torch.config import GRAZ_IMG_MEAN, GRAZ_IMG_STD
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.hpo.study import GridSampler, create_study
from samcarriestheburden_torch.ops.dice import multilabel_dice

STRUCT_ELEMENTS = ["square", "disk", "diamond", "star"]


@torch.no_grad()
def val_predictions(model_id: str, data_root: str, device=None):
    """The shared setup: (U-Net probabilities (N, 17, H, W) fp32, ground
    truth (N, 17, H, W) bool, stems) over the validation split, the tensors
    on ``device``."""
    from samcarriestheburden_torch.data.datasets import LightSegGrazPedWriDataset
    from samcarriestheburden_torch.models.modelio import ModelRegistry

    dev = resolve_device(device)
    _, unet = ModelRegistry(Path(data_root) / "model_registry").load(model_id, dev)
    xs, ys, names = LightSegGrazPedWriDataset("val", data_root=data_root).as_arrays()
    x = torch.from_numpy(xs).to(dev)
    probs = torch.sigmoid(unet((x - GRAZ_IMG_MEAN) / GRAZ_IMG_STD))
    return probs, torch.from_numpy(ys).to(dev).bool(), names


def dice_diff_score(refined: torch.Tensor, baseline: torch.Tensor, gt: torch.Tensor) -> float:
    """nanmean over images and classes of Dice(refined) - Dice(baseline)."""
    return float(torch.nanmean(multilabel_dice(refined, gt) - multilabel_dice(baseline, gt)))


# ---------------------------------------------------------------------------
# Study 1: preprocessing opening (reference hpo_seg_preprocess.py)
# ---------------------------------------------------------------------------


def build_preprocess_study(model_id: str, data_root: str = "data", seed: int = 0,
                           device=None) -> Tuple:
    from samcarriestheburden_torch.ops.seg_preprocessing import opening_with_connected_component

    probs, gt, _ = val_predictions(model_id, data_root, device)

    def objective(trial):
        struct = trial.suggest_categorical("structuring_element", STRUCT_ELEMENTS)
        radius = trial.suggest_int("radius", 0, 8)
        selection = trial.suggest_categorical("selection",
                                              ["largest", "highest_probability", None])
        trial.set_user_attr("num_iter", 250)
        refined = torch.stack([opening_with_connected_component(
            y_hat, struct, radius, trial.user_attrs["num_iter"], selection) > 0.5
            for y_hat in probs])
        return dice_diff_score(refined, probs > 0.5, gt)

    space = {"structuring_element": STRUCT_ELEMENTS, "radius": list(range(9)),
             "selection": ["largest", "highest_probability", None]}
    study = create_study("maximize", "HPO segmentation preprocessing", GridSampler(space), seed)
    study.set_user_attr("model_id", model_id)
    return objective, study


# ---------------------------------------------------------------------------
# Study 2: SAM prompt x morphology grid (reference hpo_bce_unet_sam_postprocess.py)
# ---------------------------------------------------------------------------


def build_sam_refine_study(model_id: str, data_root: str = "data", sam_type: str = "SAM",
                           seed: int = 0, decoder_head=None, device=None) -> Tuple:
    """``decoder_head``: a ready ``SamMaskDecoderHead`` in place of
    ``sam_type``'s checkpoint and embeddings under ``data_root``."""
    from samcarriestheburden_torch.engine.refinement import SamSegRefiner, SegEnhance

    dev = resolve_device(device)
    probs, gt, names = val_predictions(model_id, data_root, dev)
    prompt_choices = ["box", "pos_points neg_points", "pos_points"]

    def objective(trial):
        p1 = trial.suggest_categorical("prompts2use1st", prompt_choices).split()
        p2 = trial.suggest_categorical("prompts2use2nd", prompt_choices + [None])
        prompts2use = p1 if p2 is None else [p1, p2.split()]
        refiner = SamSegRefiner(decoder_head if decoder_head is not None else sam_type,
                                dev, prompts2use, data_root=data_root)
        seg_processor = SegEnhance(
            refiner, "highest_probability",
            trial.suggest_categorical("morph_op", ["erosion", "dilation"]),
            trial.suggest_categorical("structuring_element", STRUCT_ELEMENTS),
            trial.suggest_int("radius", 0, 8), None)
        # the whole validation split in one batched refinement
        masks, _ = seg_processor.enhance_batch(probs, list(names))
        return dice_diff_score(masks.bool(), probs > 0.5, gt)

    space = {"prompts2use1st": prompt_choices, "prompts2use2nd": prompt_choices + [None],
             "structuring_element": STRUCT_ELEMENTS, "radius": list(range(9)),
             "morph_op": ["erosion", "dilation"]}
    study = create_study("maximize", f"SAM refinement study for {model_id}",
                         GridSampler(space), seed)
    study.set_user_attr("model_id", model_id)
    return objective, study


# ---------------------------------------------------------------------------
# Study 3: random walk (reference hpo_bce_unet_rndwalk_postprocess.py)
# ---------------------------------------------------------------------------


def build_rndwalk_study(model_id: str, data_root: str = "data", seed: int = 0,
                        device=None) -> Tuple:
    from samcarriestheburden_torch.engine.refinement import RndWalkSegRefiner, SegEnhance

    dev = resolve_device(device)
    probs, gt, names = val_predictions(model_id, data_root, dev)
    img_dir = Path(data_root) / "img_only_front_all_left"

    def objective(trial):
        refiner = RndWalkSegRefiner(trial.suggest_int("background_erosion_radius", 1, 16),
                                    trial.suggest_float("laplace_sigma", 1, 20),
                                    img_path=img_dir, device=dev)
        seg_processor = SegEnhance(refiner, "highest_probability", "erosion", "disk",
                                   trial.suggest_int("radius", 0, 16), None)
        refined = torch.stack([seg_processor.enhance(y_hat, name)[0]
                               for y_hat, name in zip(probs, names)])
        return dice_diff_score(refined, probs > 0.5, gt)

    study = create_study("maximize", f"RndWalk refinement study for {model_id}",
                         seed=seed)  # the TPE sampler, the reference's default
    study.set_user_attr("model_id", model_id)
    return objective, study
