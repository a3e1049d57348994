"""Configuration dataclasses of the SAM model family.

Mirrors ``samcarriestheburden_tpu/config.py`` field for field, so a config
serialised by either package loads in the other.  Kept as a separate copy:
this package imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple


class _ConfigBase:
    """JSON round-tripping shared by all config dataclasses."""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ImageEncoderConfig(_ConfigBase):
    """ViTDet-style image encoder (reference segment_anything/modeling/image_encoder.py:17)."""

    img_size: int = 1024
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    out_chans: int = 256
    qkv_bias: bool = True
    use_abs_pos: bool = True
    use_rel_pos: bool = True
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = ()
    layer_norm_eps: float = 1e-6

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclass(frozen=True)
class PromptEncoderConfig(_ConfigBase):
    """Reference: segment_anything/modeling/prompt_encoder.py:16."""

    embed_dim: int = 256
    image_embedding_size: Tuple[int, int] = (64, 64)
    input_image_size: Tuple[int, int] = (1024, 1024)
    mask_in_chans: int = 16


@dataclass(frozen=True)
class MaskDecoderConfig(_ConfigBase):
    """Reference: segment_anything/modeling/mask_decoder.py:16 + transformer.py:16."""

    transformer_dim: int = 256
    transformer_depth: int = 2
    transformer_mlp_dim: int = 2048
    transformer_num_heads: int = 8
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


@dataclass(frozen=True)
class SamConfig(_ConfigBase):
    """Composite SAM (reference segment_anything/modeling/sam.py:18, build_sam.py:55-101)."""

    image_encoder: ImageEncoderConfig = field(default_factory=ImageEncoderConfig)
    prompt_encoder: PromptEncoderConfig = field(default_factory=PromptEncoderConfig)
    mask_decoder: MaskDecoderConfig = field(default_factory=MaskDecoderConfig)
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    mask_threshold: float = 0.0
    image_format: str = "RGB"

    @classmethod
    def from_json(cls, payload: str) -> "SamConfig":
        raw = json.loads(payload)
        raw["image_encoder"] = ImageEncoderConfig(**{
            **raw["image_encoder"],
            "global_attn_indexes": tuple(raw["image_encoder"]["global_attn_indexes"]),
        })
        pe = raw["prompt_encoder"]
        raw["prompt_encoder"] = PromptEncoderConfig(**{
            **pe,
            "image_embedding_size": tuple(pe["image_embedding_size"]),
            "input_image_size": tuple(pe["input_image_size"]),
        })
        raw["mask_decoder"] = MaskDecoderConfig(**raw["mask_decoder"])
        raw["pixel_mean"] = tuple(raw["pixel_mean"])
        raw["pixel_std"] = tuple(raw["pixel_std"])
        return cls(**raw)


def sam_vit_h_config() -> SamConfig:
    """ViT-H preset (reference build_sam.py:14-21)."""
    return SamConfig(image_encoder=ImageEncoderConfig(
        embed_dim=1280, depth=32, num_heads=16, global_attn_indexes=(7, 15, 23, 31)))


def sam_vit_l_config() -> SamConfig:
    """ViT-L preset (reference build_sam.py:27-34)."""
    return SamConfig(image_encoder=ImageEncoderConfig(
        embed_dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23)))


def sam_vit_b_config() -> SamConfig:
    """ViT-B preset (reference build_sam.py:37-44)."""
    return SamConfig(image_encoder=ImageEncoderConfig(
        embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11)))


def sam_vit_t_config(img_size: int = 128) -> SamConfig:
    """Tiny test config: the full architecture at toy widths (8x8 grid,
    window 5, so windows are ragged and carry dead slots)."""
    grid = img_size // 16
    return SamConfig(
        image_encoder=ImageEncoderConfig(
            img_size=img_size, embed_dim=32, depth=2, num_heads=2,
            global_attn_indexes=(1,), window_size=5, out_chans=16),
        prompt_encoder=PromptEncoderConfig(
            embed_dim=16, image_embedding_size=(grid, grid),
            input_image_size=(img_size, img_size), mask_in_chans=4),
        mask_decoder=MaskDecoderConfig(
            transformer_dim=16, transformer_mlp_dim=32, transformer_num_heads=2,
            iou_head_hidden_dim=16),
    )


#: The 17 wrist-bone classes of GrazPedWri (reference seg_grazpedwri_dataset.py:26-43).
N_CLASSES = 17

#: U-Net input resolution (H, W), the grid the refinement lands on
#: (reference seg_grazpedwri_dataset.py:51).
UNET_INPUT_HW = (384, 224)
