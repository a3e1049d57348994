"""SamPredictor: set an image once, predict many prompts (JAX
``engine/predictor.py``, reference segment_anything/predictor.py).

The encoder runs through :func:`engine.embeddings.make_encode_batch` on
weights packed once in ``__init__``: the image, resized longest side first
(``resize_longest_side_np``, PIL's bits), goes in as uint8, zero-padded to
the square encoder input and normalised under its validity mask, so one
encoder serves every image and AMG crop size.  The prompts and the decoder
run in fp32 on the model's device.  Prompts in the original frame are numpy
or tensors (:meth:`predict`); :meth:`predict_batched` (the reference's
``predict_torch``) takes them in the resized frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from samcarriestheburden_torch.models.sam import SamModel
from samcarriestheburden_torch.ops.resize import (apply_boxes, apply_coords,
                                                  get_preprocess_shape, resize_longest_side_np)


def _tensor(x, device, dtype=None) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x, dtype=dtype).to(device)


class SamPredictor:
    def __init__(self, sam_model: SamModel, *, dtype=None):
        """``dtype``: the encoder's compute type; None is bf16 on the card
        (the only type its kernels take: an explicit fp32 there raises in
        the kernel wrappers) and fp32 on the CPU.  The encoder's weights are
        packed here, once."""
        from samcarriestheburden_torch.engine.embeddings import make_encode_batch

        self.model = sam_model
        if dtype is None:
            dtype = torch.bfloat16 if sam_model.device.type == "cuda" else torch.float32
        self.dtype = dtype
        self._encode = make_encode_batch(sam_model, dtype)
        self._packed = sam_model.image_encoder.pack(dtype)
        self.reset_image()

    # ------------------------------------------------------------------

    def set_image(self, image: np.ndarray, image_format: str = "RGB") -> None:
        """image: HWC uint8 (reference predictor.py:34-60)."""
        if image_format not in ("RGB", "BGR"):
            raise ValueError(f"image_format must be in ['RGB', 'BGR'], is {image_format}.")
        if image_format != self.model.image_format:
            image = image[..., ::-1]
        input_image = resize_longest_side_np(np.ascontiguousarray(image), self.model.img_size)
        self.set_input_image(np.ascontiguousarray(input_image.transpose(2, 0, 1)),
                             image.shape[:2])

    def set_input_image(self, transformed_image, original_image_size: Tuple[int, int]) -> None:
        """(3, H, W) uint8 image, already resized longest side first
        (reference ``set_torch_image``, predictor.py:62-90)."""
        if not (transformed_image.ndim == 3 and transformed_image.shape[0] == 3
                and max(transformed_image.shape[1:]) == self.model.img_size):
            raise ValueError(f"input must be CHW with long side {self.model.img_size}.")
        self.reset_image()
        self.original_size = tuple(int(v) for v in original_image_size)
        self.input_size = tuple(int(v) for v in transformed_image.shape[-2:])
        size = self.model.img_size
        dev = self.model.device
        padded = torch.zeros((1, 3, size, size), dtype=torch.uint8, device=dev)
        padded[0, :, :self.input_size[0], :self.input_size[1]] = torch.as_tensor(
            transformed_image).to(dev)
        self.features = self._encode(self._packed, padded,
                                     torch.tensor([self.input_size], dtype=torch.int32))
        self.is_image_set = True

    set_torch_image = set_input_image  # reference spelling

    # ------------------------------------------------------------------

    @torch.no_grad()
    def predict(self, point_coords=None, point_labels=None, box=None, mask_input=None,
                multimask_output: bool = True, return_logits: bool = False):
        """Original-frame prompts (reference predictor.py:92-166) -> numpy
        (masks (C, H, W), iou (C,), low-res logits (C, 256, 256))."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) before mask prediction.")
        coords = labels = boxes = mask_arr = None
        if point_coords is not None:
            if point_labels is None:
                raise ValueError("point_labels must be supplied if point_coords is supplied.")
            coords = apply_coords(point_coords, self.original_size, self.model.img_size)[None]
            labels = torch.as_tensor(np.asarray(point_labels), dtype=torch.int32)[None]
        if box is not None:
            boxes = apply_boxes(box, self.original_size, self.model.img_size).reshape(1, 4)
        if mask_input is not None:
            mask_arr = torch.as_tensor(np.asarray(mask_input), dtype=torch.float32)[None]
        masks, iou, low_res = self.predict_batched(coords, labels, boxes, mask_arr,
                                                   multimask_output, return_logits)
        return masks[0].cpu().numpy(), iou[0].cpu().numpy(), low_res[0].cpu().numpy()

    @torch.no_grad()
    def predict_batched(self, point_coords=None, point_labels=None, boxes=None,
                        mask_input=None, multimask_output: bool = True,
                        return_logits: bool = False):
        """Input-frame batched prompts (reference ``predict_torch``,
        predictor.py:168-243) -> tensors on the model's device."""
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) before mask prediction.")
        dev = self.model.device
        points = None
        if point_coords is not None:
            points = (_tensor(point_coords, dev, torch.float32),
                      _tensor(point_labels, dev, torch.int32))
        sparse, dense = self.model.encode_prompts(
            points=points, boxes=_tensor(boxes, dev, torch.float32),
            masks=_tensor(mask_input, dev, torch.float32))
        low_res, iou = self.model.decode_masks(
            self.features, self.model.get_dense_pe(), sparse, dense, multimask_output,
            # one image and no per-prompt mask input: the image side is shared
            image_shared=mask_input is None and self.features.shape[0] == 1)
        masks = self.model.postprocess_masks(low_res, self.input_size, self.original_size)
        if not return_logits:
            masks = masks > self.model.mask_threshold
        return masks, iou, low_res

    predict_torch = predict_batched  # reference spelling

    # ------------------------------------------------------------------

    def get_image_embedding(self) -> torch.Tensor:
        if not self.is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) to generate an "
                               "embedding.")
        return self.features

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def transform(self):
        """The reference's ResizeLongestSide surface: the shape math."""
        return _TransformShim(self.model.img_size)

    def reset_image(self) -> None:
        self.is_image_set = False
        self.features = None
        self.original_size = None
        self.input_size = None


class _TransformShim:
    """ResizeLongestSide's methods (reference utils/transforms.py), numpy in and out."""

    def __init__(self, target_length: int):
        self.target_length = target_length

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        return resize_longest_side_np(image, self.target_length)

    def apply_coords(self, coords, original_size) -> np.ndarray:
        return apply_coords(np.asarray(coords, np.float32), tuple(original_size),
                            self.target_length).numpy()

    def apply_boxes(self, boxes, original_size) -> np.ndarray:
        return apply_boxes(np.asarray(boxes, np.float32), tuple(original_size),
                           self.target_length).numpy()

    @staticmethod
    def get_preprocess_shape(oldh, oldw, long_side_length):
        return get_preprocess_shape(oldh, oldw, long_side_length)
