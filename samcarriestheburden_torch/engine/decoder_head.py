"""Decoder-only SAM over precomputed image embeddings (JAX
``engine/decoder_head.py``, reference segment_anything/sam_mask_decoder_head.py).

The prompt encoder (float32) and the mask decoder (float32, or bf16 with
``compute_dtype=torch.bfloat16``) read an embeddings store (an h5 path or
any reader with ``EmbeddingReader``'s interface):

* :meth:`SamMaskDecoderHead.predict_mask` — the reference API, one prompt at
  a time, masks at the original resolution;
* :meth:`SamMaskDecoderHead.decode_batched` — every class of an image in one
  call from fixed-shape prompt tensors; the refinement engine lands its
  logits on the U-Net grid with :func:`postprocess_to_grid`.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Mapping, Optional, Union

import numpy as np
import torch

from samcarriestheburden_torch.config import (SamConfig, sam_vit_b_config, sam_vit_h_config,
                                              sam_vit_l_config, sam_vit_t_config)
from samcarriestheburden_torch.data.h5io import EmbeddingReader
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.engine import postprocess
from samcarriestheburden_torch.engine.prompts import Prompt
from samcarriestheburden_torch.models import convert
from samcarriestheburden_torch.models.mask_decoder import MaskDecoder
from samcarriestheburden_torch.models.prompt_encoder import PromptEncoder
from samcarriestheburden_torch.models.sam import SamModel
from samcarriestheburden_torch.ops.resize import resize_bilinear, scale_box, scale_coords

KNOWN_PROMPTS = ("pos_points", "neg_points", "box")
CONFIGS = {"vit_h": sam_vit_h_config, "vit_l": sam_vit_l_config,
           "vit_b": sam_vit_b_config, "vit_t": sam_vit_t_config}


def _sub_state_dict(sd: Mapping[str, torch.Tensor], prefix: str):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


class SamMaskDecoderHead:
    def __init__(self, sam_checkpoint, model_type: str, img_embedding_h5, device=None, *,
                 params: Union[SamModel, Mapping[str, torch.Tensor], None] = None,
                 cfg: Optional[SamConfig] = None, compute_dtype: Optional[torch.dtype] = None):
        """``sam_checkpoint``: full SAM weights, a reference ``.pth`` or a
        JAX-package ``.npz`` (its image encoder is not kept); its file name
        must be the one the embeddings store records.  ``params`` in its
        place: a :class:`SamModel` or a SAM state dict.  ``img_embedding_h5``:
        a path, or an open reader with ``features``, ``sizes``,
        ``checkpoint`` and ``img_encoder_img_size``.  ``device=None`` is the
        card.  ``compute_dtype``: the mask decoder's compute type, ``None``
        for float32 (JAX ``compute_dtype``); ``torch.bfloat16`` is the serving
        setting ``bench.py`` measures.  The prompt encoder stays in float32 and
        the logits and IoU come back in float32 either way."""
        self.device = resolve_device(device)
        self.cfg: SamConfig = cfg if cfg is not None else CONFIGS[model_type]()
        self.reader = (img_embedding_h5 if hasattr(img_embedding_h5, "features")
                       else EmbeddingReader(img_embedding_h5))
        self.img_enc_img_size = int(self.reader.img_encoder_img_size)
        if sam_checkpoint is not None and self.reader.checkpoint != Path(sam_checkpoint).name:
            raise ValueError("SAM checkpoint mismatch: the embeddings were made with "
                             f"{self.reader.checkpoint!r}")

        if params is None:
            if Path(sam_checkpoint).suffix == ".npz":
                sd = convert.load_jax_decoder_checkpoint(sam_checkpoint)
            else:
                sd = convert.load_reference_checkpoint(sam_checkpoint)
        elif isinstance(params, SamModel):
            sd = params.state_dict()
        else:
            sd = params
        self.prompt_encoder = PromptEncoder(self.cfg.prompt_encoder)
        self.prompt_encoder.load_state_dict(_sub_state_dict(sd, "prompt_encoder."))
        self.mask_decoder = MaskDecoder(self.cfg.mask_decoder)
        self.mask_decoder.load_state_dict(_sub_state_dict(sd, "mask_decoder."))
        self.prompt_encoder.to(self.device).eval()
        self.mask_decoder.to(self.device).eval()
        self.mask_threshold = self.cfg.mask_threshold
        self.compute_dtype = torch.float32 if compute_dtype is None else compute_dtype
        self._features_cache = (None, None)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _decode(self, features, coords, labels, mask_input, use_mask, image_shared=False):
        """features (n_img, C, G, G); coords (B, N, 2) input-frame xy; labels
        (B, N) in {-1, 0, 1, 2, 3}; mask_input (B, 1, 4G, 4G); use_mask (B,)
        bool; the B items image-major, B // n_img per image.  Returns (low_res
        (B, 1, 4G, 4G), iou (B, 1)) in float32.

        ``image_shared``: the caller promises no item uses a mask input (round
        1 of the refinement), so every item sees the no-mask dense embedding
        and the decoder projects each image's side once."""
        pe = self.prompt_encoder
        sparse = pe.embed_unified_points(coords, labels)
        if image_shared:
            dense = pe.no_mask_dense(1)
        else:
            dense = pe.embed_masks_or_default(mask_input, use_mask)
        return self.mask_decoder(features, pe.get_dense_pe(), sparse, dense,
                                 multimask_output=False, image_shared=image_shared,
                                 dtype=self.compute_dtype)

    def decode_batched(self, features, coords, labels, mask_input=None, use_mask=None):
        """Decode B prompt sets of n_img images (features (n_img, C, G, G),
        image-major items) with fixed shapes; without ``mask_input`` no item
        uses a mask."""
        dev = self.device
        coords = torch.as_tensor(coords, dtype=torch.float32, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        b = coords.shape[0]
        g4 = self.cfg.prompt_encoder.image_embedding_size[0] * 4
        if mask_input is None:
            mask_input = torch.zeros((b, 1, g4, g4), device=dev)
            use_mask = torch.zeros((b,), dtype=torch.bool, device=dev)
        if use_mask is None:
            use_mask = torch.ones((b,), dtype=torch.bool, device=dev)
        return self._decode(torch.as_tensor(features, dtype=torch.float32, device=dev),
                            coords, labels,
                            torch.as_tensor(mask_input, dtype=torch.float32, device=dev),
                            torch.as_tensor(use_mask, device=dev))

    # ------------------------------------------------------------------
    # the embeddings store
    # ------------------------------------------------------------------

    def features(self, img_name: str) -> torch.Tensor:
        cached_name, cached = self._features_cache
        if cached_name != img_name:
            cached = torch.as_tensor(self.reader.features(img_name)).to(self.device,
                                                                         torch.float32)
            self._features_cache = (img_name, cached)
        return cached

    def sizes(self, img_name: str):
        """(original_size, input_size) of an image, each (2,) as (H, W)."""
        return self.reader.sizes(img_name)

    # ------------------------------------------------------------------
    # reference API (sam_mask_decoder_head.py:37-104)
    # ------------------------------------------------------------------

    def predict_mask(self, img_name: str, given_prompt: Prompt,
                     prompt2use: Union[str, List[str]], mask_prev_iter=None):
        """Returns (masks > threshold at the original size, iou, low-res logits)."""
        if isinstance(prompt2use, str):
            prompt2use = [prompt2use]
        if not all(p in KNOWN_PROMPTS for p in prompt2use):
            raise ValueError(f"Prompt must be one of {list(KNOWN_PROMPTS)}")
        original_size, input_size = self.sizes(img_name)

        coords_parts, labels_parts = [], []
        for name, label in (("pos_points", 1), ("neg_points", 0)):
            if name in prompt2use:
                seeds = given_prompt.pos_seeds if label else given_prompt.neg_seeds
                if seeds is None:
                    raise ValueError(f"{name} are not available")
                pts = scale_coords(np.asarray(seeds), given_prompt.img_size, input_size)
                coords_parts.append(pts)
                labels_parts.append(torch.full((len(pts),), label, dtype=torch.int32))
        has_points = len(coords_parts) > 0
        if "box" in prompt2use:
            if given_prompt.box is None:
                raise ValueError("box is not available")
            box = scale_box(np.asarray(given_prompt.box)[None], given_prompt.img_size,
                            input_size)[0]
            coords_parts.append(box.reshape(2, 2))
            labels_parts.append(torch.tensor([2, 3], dtype=torch.int32))
        elif has_points:      # the reference pads points without a box (prompt_encoder.py:81-85)
            coords_parts.append(torch.zeros((1, 2)))
            labels_parts.append(torch.tensor([-1], dtype=torch.int32))

        coords = torch.cat(coords_parts)[None]
        labels = torch.cat(labels_parts)[None]
        if mask_prev_iter is not None:
            mask_input = torch.as_tensor(mask_prev_iter, dtype=torch.float32)
            use_mask = torch.ones((1,), dtype=torch.bool)
        else:
            mask_input, use_mask = None, None
        low_res, iou = self.decode_batched(self.features(img_name), coords, labels,
                                           mask_input, use_mask)
        masks = self._postprocess_original(low_res, tuple(int(v) for v in input_size),
                                           tuple(int(v) for v in original_size))
        return masks > self.mask_threshold, iou, low_res

    def _postprocess_original(self, low_res, input_size, original_size):
        """The reference postprocess (sam_mask_decoder_head.py:106-135):
        bilinear to the encoder's input size, crop, bilinear to the original."""
        size = self.img_enc_img_size
        masks = resize_bilinear(low_res, (size, size))
        masks = masks[..., :input_size[0], :input_size[1]]
        return resize_bilinear(masks, tuple(original_size))

    def postprocess_to_grid(self, low_res, input_size, original_size, out_hw):
        return postprocess.postprocess_to_grid(low_res, input_size, original_size,
                                               tuple(out_hw),
                                               img_enc_size=self.img_enc_img_size,
                                               mask_threshold=self.mask_threshold)
