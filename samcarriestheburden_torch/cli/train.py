"""Initial f_θ training on the annotated subset (JAX ``cli/train.py``,
reference unet_training/training.py).

python -m samcarriestheburden_torch.cli.train --num_train_samples 43 [--bf16] [--cpu]

Trains on the card (``--cpu`` for the CPU; without a card it raises) and
registers the model in ``<data_root>/model_registry`` in the JAX package's
schema, so the JAX package and the port's CLIs load it by its id.
"""

from __future__ import annotations

from samcarriestheburden_torch.cli.common import (add_profile_flag, hp_parser, maybe_mesh,
                                                  on_rank0, profiled, setup_backend,
                                                  train_config_from_args)


def main(argv=None):
    parser = hp_parser()
    add_profile_flag(parser)
    parser.add_argument("--architecture", default="unet", choices=["unet"],
                        help="which architecture to use")
    parser.add_argument("--data_sample_per_epoch", type=int, default=48,
                        help="number of samples per epoch. Used for bootstrapping.")
    parser.add_argument("--num_train_samples", type=int, default=-1,
                        help="number of training samples to use. -1 means all samples.")
    hp = parser.parse_args(argv)
    device = setup_backend(hp)
    mesh = maybe_mesh(hp)

    from samcarriestheburden_torch.config import UNetConfig
    from samcarriestheburden_torch.data.datasets import LightSegGrazPedWriDataset
    from samcarriestheburden_torch.models.modelio import ModelRegistry
    from samcarriestheburden_torch.train.logging import RunLogger
    from samcarriestheburden_torch.train.loop import train_unet

    tags = ["instance_norm", "bootstrap"]
    if hp.data_aug > 0:
        tags.append("data_aug")
    if hp.lr_scheduler:
        tags.append("lr_scheduler")
    n_samples = "all" if hp.num_train_samples == -1 else hp.num_train_samples
    rank0 = mesh is None or mesh.index == 0
    logger = RunLogger("Kids Bone Checker/Bone segmentation/fewer samples",
                       f"initial on {n_samples} training data", tags,
                       config=vars(hp)) if rank0 else None

    ds_train = LightSegGrazPedWriDataset("train", n_samples, data_root=hp.data_root)
    ds_val = LightSegGrazPedWriDataset("val", data_root=hp.data_root)
    x_tr, y_tr, _ = ds_train.as_arrays()
    x_va, y_va, _ = ds_val.as_arrays()

    unet_cfg = UNetConfig(n_channels=1, n_classes=ds_train.N_CLASSES,
                          n_last_channel=hp.n_last_channel)
    train_cfg = train_config_from_args(
        hp, data_sample_per_epoch=hp.data_sample_per_epoch,
        num_train_samples=hp.num_train_samples)

    with profiled(hp.profile):
        model, history = train_unet((x_tr, y_tr), (x_va, y_va), unet_cfg,
                                    train_cfg, logger=logger,
                                    bone_labels=ds_train.BONE_LABEL,
                                    mesh=mesh, progress=True, device=device)

    # the registry and the logger write on rank 0; every rank returns its id
    model_id = on_rank0(lambda: ModelRegistry(f"{hp.data_root}/model_registry").register(
        unet_cfg, model, name="final_model",
        metadata={"task": logger.dir.name, "val_dice": history[-1]["val_dice"]}))
    print(f"final val dice: {history[-1]['val_dice']:.4f}")
    print(f"model id: {model_id}")
    if logger is not None:
        logger.close()
    return model_id


if __name__ == "__main__":
    main()
