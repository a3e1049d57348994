"""The program's configuration objects from the benchmark's configuration
files, the reference models with the run's seeded weights, and the switch
that keeps the reference in full float32."""

from __future__ import annotations

import torch

from harness.weights import seeded_state_dict
from reference import sam as ref_sam
from reference import unet as ref_unet


def port_sam_config(c: dict):
    """The program's ``SamConfig`` from a SAM configuration's sizes."""
    from samcarriestheburden_torch.config import (ImageEncoderConfig, MaskDecoderConfig,
                                                  PromptEncoderConfig, SamConfig)
    g = c["image_size"] // c["vit_patch_size"]
    return SamConfig(
        image_encoder=ImageEncoderConfig(
            img_size=c["image_size"], patch_size=c["vit_patch_size"],
            embed_dim=c["encoder_embed_dim"], depth=c["encoder_depth"],
            num_heads=c["encoder_num_heads"], mlp_ratio=c["mlp_ratio"],
            out_chans=c["prompt_embed_dim"], window_size=c["window_size"],
            global_attn_indexes=tuple(c["encoder_global_attn_indexes"])),
        prompt_encoder=PromptEncoderConfig(
            embed_dim=c["prompt_embed_dim"], image_embedding_size=(g, g),
            input_image_size=(c["image_size"], c["image_size"]),
            mask_in_chans=c["mask_in_chans"]),
        mask_decoder=MaskDecoderConfig(
            transformer_dim=c["prompt_embed_dim"], transformer_depth=c["transformer_depth"],
            transformer_mlp_dim=c["transformer_mlp_dim"],
            transformer_num_heads=c["transformer_num_heads"],
            num_multimask_outputs=c["num_multimask_outputs"],
            iou_head_depth=c["iou_head_depth"], iou_head_hidden_dim=c["iou_head_hidden_dim"]),
        pixel_mean=tuple(c["pixel_mean"]), pixel_std=tuple(c["pixel_std"]))


def port_unet_config(u: dict):
    from samcarriestheburden_torch.config import UNetConfig
    return UNetConfig(n_channels=u["n_channels"], n_classes=u["n_classes"],
                      n_last_channel=u["n_last_channel"], base_channels=u["base_channels"])


def seeded(module_fn, seed: int, device):
    """(the module built by ``module_fn()`` holding the seeded weights,
    the state dict) for ``seed`` on ``device``."""
    with torch.device("meta"):
        module = module_fn()
    sd = seeded_state_dict(module, seed, device)
    module.load_state_dict(sd, assign=True)
    return module.eval(), sd


def reference_sam(c: dict, seed: int, device, encoder: bool = True) -> ref_sam.Sam:
    return seeded(lambda: ref_sam.Sam(c, encoder), seed, device)[0]


def reference_unet(u: dict, seed: int, device) -> ref_unet.UNet:
    return seeded(lambda: ref_unet.UNet(u), seed, device)[0]


class full_fp32:
    """Float32 products and convolutions in full float32 (TF32 off) inside
    the block, the settings restored after; ``tf32=True`` turns TF32 on
    instead (the control of a float32 stage)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False
