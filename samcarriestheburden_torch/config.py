"""Configuration dataclasses of the SAM model family, the U-Net, its training
and the refinement engine, and the GrazPedWri dataset constants.

Mirrors ``samcarriestheburden_tpu/config.py`` field for field, so a config
serialised by either package loads in the other.  Kept as a separate copy:
this package imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


class _ConfigBase:
    """JSON round-tripping shared by all config dataclasses."""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, payload: str):
        return cls(**json.loads(payload))

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


@dataclass(frozen=True)
class UNetConfig(_ConfigBase):
    """Classic 4-down/4-up U-Net (reference custom_arcitecture/classic_u_net.py:81-106)."""

    n_channels: int = 1
    n_classes: int = 17
    bilinear: bool = False
    n_last_channel: int = 64
    base_channels: int = 64


@dataclass(frozen=True)
class TrainConfig(_ConfigBase):
    """Mirrors the shared argparse flags (reference unet_training/hyper_params.py:3-19
    and training.py:14-19)."""

    seed: int = 42
    lr: float = 1e-3
    batch_size: int = 16
    infer_batch_size: int = 16
    weight_decay: float = 0.0
    epochs: int = 350
    data_aug: float = 0.03
    lr_scheduler: bool = True
    n_last_channel: int = 64
    data_sample_per_epoch: int = 48
    num_train_samples: int = -1  # -1 == all
    #: 'bootstrap' = sample with replacement (initial training, training.py:41-42);
    #: 'shuffle' = shuffled full epochs with drop_last (pseudo-label training,
    #: training_on_pseudo_labels.py:65-66)
    sample_mode: str = "bootstrap"
    #: forward-pass compute precision: 'float32' (reference parity; TF32
    #: convolutions on the card, PyTorch's default) or 'bfloat16' (bf16
    #: forward; params, loss and optimizer stay fp32)
    compute_dtype: str = "float32"
    #: augment a whole epoch before its steps and read its losses back once.
    #: None = auto: on for the card, off for the CPU
    epoch_scan: Optional[bool] = None
    #: augmentation warp: None = auto ('gather', the 4-tap formulation, which
    #: is the faster one on the H100 and on the CPU); 'matmul' / 'gather' to force
    aug_method: Optional[str] = None
    #: dataset residency on a mesh: 'replicated' (the whole split on every
    #: rank's card) or 'sharded' (each rank keeps its block of the split)
    data_placement: str = "replicated"
    #: data-parallel device count: one card per process, so the mesh's size
    num_devices: int = 1


@dataclass(frozen=True)
class RefineConfig(_ConfigBase):
    """The authors' HPO-selected refinement knobs
    (reference scripts/save_refined_segmentations.py:25-31)."""

    prompts_first: Tuple[str, ...] = ("box",)
    prompts_second: Optional[Tuple[str, ...]] = ("pos_points", "neg_points")
    ccl_selection: Optional[str] = "highest_probability"  # 'largest' | 'highest_probability' | None
    morph_op: str = "dilation"  # 'erosion' | 'dilation'
    struct_element: str = "square"  # 'square' | 'disk' | 'diamond' | 'star'
    radius: int = 8
    max_neg_seeds: int = 16  # static padded capacity for vmapped prompts (N_CLASSES-1)

    @classmethod
    def from_json(cls, payload: str) -> "RefineConfig":
        raw = json.loads(payload)
        raw["prompts_first"] = tuple(raw["prompts_first"])
        if raw.get("prompts_second") is not None:
            raw["prompts_second"] = tuple(raw["prompts_second"])
        return cls(**raw)


#: Per-channel normalisation over the GrazPedWri training split
#: (reference scripts/seg_grazpedwri_dataset.py:22-23).
GRAZ_IMG_MEAN = 0.3505533917353781
GRAZ_IMG_STD = 0.22763733675869177

#: The 17 wrist-bone classes of GrazPedWri, sorted (reference seg_grazpedwri_dataset.py:26-43).
BONE_LABEL: Tuple[str, ...] = tuple(sorted([
    "Radius",
    "Ulna",
    "Os scaphoideum",
    "Os lunatum",
    "Os triquetrum",
    "Os pisiforme",
    "Os trapezium",
    "Os trapezoideum",
    "Os capitatum",
    "Os hamatum",
    "Ossa metacarpalia I",
    "Ossa metacarpalia II",
    "Ossa metacarpalia III",
    "Ossa metacarpalia IV",
    "Ossa metacarpalia V",
    "Epiphyse Radius",
    "Epiphyse Ulna",
]))
BONE_LABEL_MAPPING = {k: v for v, k in enumerate(BONE_LABEL)}
N_CLASSES = len(BONE_LABEL)

#: Per-class positive BCE weights (reference seg_grazpedwri_dataset.py:47-49).
POS_CLASS_WEIGHT: Tuple[float, ...] = (
    108.1348, 349.1551, 69.6342, 96.0886, 167.7897, 364.5914, 131.5362,
    176.2591, 240.9182, 169.5408, 60.1363, 46.6512, 51.6916, 58.6216,
    52.5956, 11.2623, 17.9409,
)

#: U-Net input resolution (H, W), the grid the refinement lands on
#: (reference seg_grazpedwri_dataset.py:51).
UNET_INPUT_HW = (384, 224)
