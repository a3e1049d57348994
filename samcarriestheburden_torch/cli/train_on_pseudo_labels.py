"""Final f_φ training on refined pseudo labels (JAX
``cli/train_on_pseudo_labels.py``, reference
unet_training/training_on_pseudo_labels.py).

python -m samcarriestheburden_torch.cli.train_on_pseudo_labels \\
    --model_id <initial-model-id> --pseudo_label sam \\
    --prompt1st box --prompt2nd pos_points neg_points [--bf16] [--cpu]

Trains on the card (``--cpu`` for the CPU; without a card it raises) and
registers the model in the JAX package's registry schema.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from samcarriestheburden_torch.cli.common import (hp_parser, maybe_mesh, on_rank0, setup_backend,
                                                  train_config_from_args)


def pseudo_label_path(data_root: str, model_id: str, pseudo_label: str,
                      prompt1st, prompt2nd, suffix: str = "all") -> Path:
    """Path conventions (reference training_on_pseudo_labels.py:55-63).

    ``rndwalk`` extends the reference's {raw, sam, nnunet}: the JAX
    package's ``save_refined_segmentations --refiner rndwalk`` sweep writes
    ``rndwalk_<suffix>.h5`` and this CLI consumes it."""
    root = Path(data_root) / "seg_masks"
    if pseudo_label == "nnunet":
        return root / "SegGraz_nnunet_predictions.h5"
    if pseudo_label == "raw":
        return root / model_id / f"raw_segmentations_{suffix}.h5"
    if pseudo_label == "sam":
        name = "_".join(prompt1st) + "_refine_" + "_".join(prompt2nd)
        return root / model_id / f"sam_{name}_{suffix}.h5"
    if pseudo_label == "rndwalk":
        return root / model_id / f"rndwalk_{suffix}.h5"
    raise ValueError(f"unknown pseudo_label {pseudo_label}")


def main(argv=None):
    parser = hp_parser()
    parser.add_argument("--train_from_scratch", default=True,
                        action=argparse.BooleanOptionalAction)
    parser.add_argument("--split500", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="use the predefined 500 split instead of all data")
    parser.add_argument("--pseudo_label",
                        choices=["raw", "sam", "nnunet", "rndwalk"],
                        required=True, help="pseudo label method")
    parser.add_argument("--prompt1st", type=str, nargs="*", default=None)
    parser.add_argument("--prompt2nd", type=str, nargs="*", default=None)
    parser.add_argument("--num_train_samples", type=int, default=43,
                        help="number of training samples initial model was trained on.")
    parser.add_argument("--model_id", type=str, required=True,
                        help="registry id of the initial model (replaces ClearML id)")
    parser.add_argument("--pseudo_label_suffix", type=str, default="all",
                        help="suffix of the pseudo-label h5 (file count)")
    hp = parser.parse_args(argv)
    device = setup_backend(hp)
    mesh = maybe_mesh(hp)

    from samcarriestheburden_torch.config import UNetConfig
    from samcarriestheburden_torch.data.datasets import (LightSegGrazPedWriDataset,
                                                         SavedSegGrazPedWriDataset)
    from samcarriestheburden_torch.models.modelio import ModelRegistry
    from samcarriestheburden_torch.train.logging import RunLogger
    from samcarriestheburden_torch.train.loop import train_unet

    tags = []
    if hp.data_aug > 0:
        tags.append("data_aug")
    if hp.lr_scheduler:
        tags.append("lr_scheduler")
    if not hp.train_from_scratch:
        tags.append("fine_tuning")
    if hp.pseudo_label == "sam":
        task_name = ("SAM " + "_".join(hp.prompt1st) + "_refine_"
                     + "_".join(hp.prompt2nd) + f"_num_train_{hp.num_train_samples}")
    else:
        task_name = hp.pseudo_label + f"_num_train_{hp.num_train_samples}"
    logger = RunLogger("Kids Bone Checker/Bone segmentation/pseudo label training",
                       task_name, tags, config=vars(hp)) \
        if mesh is None or mesh.index == 0 else None

    registry = ModelRegistry(f"{hp.data_root}/model_registry")
    h5_path = pseudo_label_path(hp.data_root, hp.model_id, hp.pseudo_label,
                                hp.prompt1st, hp.prompt2nd, hp.pseudo_label_suffix)
    ds_train = SavedSegGrazPedWriDataset(h5_path, use_500_split=hp.split500,
                                         data_root=hp.data_root)
    ds_val = LightSegGrazPedWriDataset("val", data_root=hp.data_root)
    x_tr, y_tr, _ = ds_train.as_arrays()
    x_va, y_va, _ = ds_val.as_arrays()

    if hp.train_from_scratch:
        unet_cfg = UNetConfig(n_channels=1, n_classes=ds_train.N_CLASSES)
        init_params = None
    else:
        unet_cfg, init_params = registry.load(hp.model_id, device=device)

    train_cfg = train_config_from_args(hp, num_train_samples=hp.num_train_samples,
                                       sample_mode="shuffle")

    model, history = train_unet((x_tr, y_tr), (x_va, y_va), unet_cfg, train_cfg,
                                logger=logger, bone_labels=ds_train.BONE_LABEL,
                                init_params=init_params, mesh=mesh,
                                progress=True, device=device)

    # the registry and the logger write on rank 0; every rank returns its id
    model_id = on_rank0(lambda: registry.register(
        unet_cfg, model, name="final_model",
        metadata={"task": task_name, "initial_model": hp.model_id,
                  "val_dice": history[-1]["val_dice"]}))
    print(f"final val dice: {history[-1]['val_dice']:.4f}")
    print(f"model id: {model_id}")
    if logger is not None:
        logger.close()
    return model_id


if __name__ == "__main__":
    main()
