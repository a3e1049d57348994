"""Segmentation refinement engine (JAX ``engine/refinement.py``, reference
utils/seg_refinement.py).

:class:`SegEnhance` keeps one connected component per class of a U-Net
probability mask (K8, ``ops/ccl.py``), morphs it, and hands it to a refiner.
:class:`SamSegRefiner` refines every class of a batch of images with SAM in
one or two rounds: round 1 decodes all N x C prompt sets at once from their
boxes (or points), each image's side projected once, round 2 from points
with round 1's logits as the mask prompt, and the logits land on the U-Net
grid through one :func:`postprocess_to_grid` call (the JAX package's vmapped
``refine_batch``, with the batch written out).  :class:`RndWalkSegRefiner`
solves a seeded random walk over the image instead (``ops/random_walk.py``,
CG on the device in place of the reference's host-side pyamg).

Reference quirks kept: the morphology's result only fills
``last_preprocessed_seg`` and the refiner gets the CCL output
(seg_refinement.py:68-70); the CCL's ``num_iter`` is ``max(H, W)`` (:66);
the estimated Dice is 2J/(1+J) of the last round's IoU head (:114).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead
from samcarriestheburden_torch.engine.postprocess import postprocess_to_grid
from samcarriestheburden_torch.engine.prompts import extract_prompt_arrays, neg_seed_table
from samcarriestheburden_torch.ops.ccl import remove_all_but_one_connected_component
from samcarriestheburden_torch.ops.dice import jaccard_to_dice
from samcarriestheburden_torch.ops.morphology import (dilation, erode_mask_with_disc_struct,
                                                      erosion, get_struct_element)
from samcarriestheburden_torch.ops.random_walk import random_walk_probs


class SegRefiner(ABC):
    @abstractmethod
    def refine(self, seg, file_name: str = None):
        ...


# ---------------------------------------------------------------------------
# SegEnhance (reference seg_refinement.py:20-72)
# ---------------------------------------------------------------------------


class SegEnhance:
    def __init__(self, refiner: SegRefiner, ccl_selection: Optional[str], morph_op: str,
                 struct_element: str, radius: int, device=None):
        """``device``: where the masks go; ``None`` takes the refiner's
        ``device`` where it has one (:class:`SamSegRefiner`: its decoder
        head's), else the card."""
        self.last_preprocessed_seg = None
        self.refiner = refiner
        self.device = device
        self.ccl_selection = ccl_selection
        op = {"erosion": erosion, "dilation": dilation}[morph_op]
        kernel = get_struct_element(struct_element, radius)
        if radius == 0 or (struct_element == "square" and radius == 1):
            self._morph = lambda m: m
        else:
            self._morph = lambda m: op(m, kernel)

    def _device(self) -> torch.device:
        if self.device is not None:
            return resolve_device(self.device)
        dev = getattr(self.refiner, "device", None)
        return dev if dev is not None else resolve_device(None)

    def _as_tensor(self, seg) -> torch.Tensor:
        return torch.as_tensor(seg).to(self._device(), torch.float32)

    def enhance(self, seg, file_name: str = None):
        """(C, H, W) probabilities -> (refined (C, H, W) bool, est_dice (C,))."""
        seg = self._as_tensor(seg)
        if seg.ndim != 3:
            raise ValueError("seg should be 3D tensor of shape (C, H, W)")
        if self.ccl_selection is not None:
            seg = remove_all_but_one_connected_component(seg, self.ccl_selection,
                                                         max(seg.shape[-2:]))
        self.last_preprocessed_seg = self._morph(seg)
        return self.refiner.refine(seg, file_name)

    def enhance_batch(self, segs, file_names: Sequence[str]):
        """``[self.enhance(s, f) for ...]`` over (N, C, H, W) probabilities,
        with the CCL of all N x C maps in one call.  Returns (refined
        (N, C, H, W) bool, est_dice (N, C)).  Needs a refiner with
        ``refine_batch``."""
        segs = self._as_tensor(segs)
        if segs.ndim != 4:
            raise ValueError("segs should be 4D (N, C, H, W)")
        if self.ccl_selection is not None:
            segs = remove_all_but_one_connected_component(segs, self.ccl_selection,
                                                          max(segs.shape[-2:]))
        self.last_preprocessed_seg = self._morph(segs)
        return self.refiner.refine_batch(segs, file_names)


# ---------------------------------------------------------------------------
# SAM refiner (reference seg_refinement.py:75-116)
# ---------------------------------------------------------------------------

_CKPT_FOR_TYPE = {
    "SAM": ("data/sam_vit_h_4b8939.pth", "vit_h", "data/graz_sam_img_embedding.h5"),
    "MedSAM": ("data/medsam_vit_b.pth", "vit_b", "data/graz_medsam_img_embedding.h5"),
}


class SamSegRefiner(SegRefiner):
    def __init__(self, sam_type: Union[str, SamMaskDecoderHead], device=None,
                 prompts2use: Union[List[List[str]], List[str]] = ("box",),
                 data_root: str = "data", max_points: Optional[int] = None):
        """``sam_type``: 'SAM' or 'MedSAM' (the reference's checkpoint and
        embeddings files under ``data_root``, seg_refinement.py:77-86), or a
        ready :class:`SamMaskDecoderHead`.  ``prompts2use``: one prompt list
        (one round) or two (round 2 refines round 1 with its logits).
        ``max_points`` is accepted and unused, as in the JAX package: every
        class takes the other classes' seeds as its negative points."""
        if isinstance(sam_type, SamMaskDecoderHead):
            self.sam_predictor = sam_type
        else:
            if sam_type not in _CKPT_FOR_TYPE:
                raise NotImplementedError(f"Unknown SAM type: {sam_type}")
            ckpt, model_type, emb = _CKPT_FOR_TYPE[sam_type]
            root = Path(data_root)
            self.sam_predictor = SamMaskDecoderHead(root / Path(ckpt).name, model_type,
                                                    root / Path(emb).name, device)
        prompts2use = list(prompts2use)
        if isinstance(prompts2use[0], (list, tuple)):
            if len(prompts2use[1]) == 0:
                raise ValueError("2nd prompt list should not be empty")
            self.prompts2use1st = list(prompts2use[0])
            self.prompts2use2nd = list(prompts2use[1])
            self.self_refine = True
        else:
            self.prompts2use1st = prompts2use
            self.prompts2use2nd = None
            self.self_refine = False

    @property
    def device(self) -> torch.device:
        return self.sam_predictor.device

    @staticmethod
    def _build_prompts(arrays: Dict[str, torch.Tensor], neg_table, neg_valid,
                       prompts: Sequence[str], seg_hw, input_size):
        """(N*C, P, 2) coords and (N*C, P) int32 labels in each image's input
        frame, image-major, from (N, C, ...) prompt arrays and (N, 2) input
        sizes.  Missing prompts are not-a-point pads (label -1, SAM's own
        padding, prompt_encoder.py:81-85), so every image has the same shapes."""
        n, c = arrays["pos_seeds"].shape[:2]
        dev = arrays["pos_seeds"].device
        factor = (input_size.float() / torch.tensor(seg_hw, dtype=torch.float32,
                                                    device=dev)).flip(-1)[:, None, None]
        coords, labels = [], []
        if "pos_points" in prompts:
            coords.append(arrays["pos_seeds"][:, :, None] * factor)
            labels.append(torch.where(arrays["pos_valid"][..., None], 1, -1))
        if "neg_points" in prompts:
            coords.append(neg_table * factor)
            labels.append(torch.where(neg_valid, 0, -1))
        if "box" in prompts:
            coords.append(arrays["boxes"].reshape(n, c, 2, 2) * factor)
            labels.append(torch.tensor([2, 3], device=dev).expand(n, c, 2))
        else:       # the reference pads points when there is no box
            coords.append(torch.zeros((n, c, 1, 2), device=dev))
            labels.append(torch.full((n, c, 1), -1, device=dev))
        coords, labels = torch.cat(coords, dim=2), torch.cat(labels, dim=2).int()
        return coords.reshape(n * c, -1, 2), labels.reshape(n * c, -1)

    @torch.no_grad()
    def _refine_batched(self, bool_mask: torch.Tensor, features: torch.Tensor,
                        input_size: torch.Tensor, original_size: torch.Tensor,
                        seg_hw: Tuple[int, int]):
        """Every class of N images: (N, C, H, W) masks, (N, 256, G, G)
        features, (N, 2) input and original sizes -> (refined (N, C, H, W)
        bool, est_dice (N, C)).  One decode per round over all N*C prompt
        sets, one grid postprocess."""
        head = self.sam_predictor
        n, c = bool_mask.shape[:2]
        arrays = extract_prompt_arrays(bool_mask)
        neg_table, neg_valid = neg_seed_table(arrays["pos_seeds"], arrays["pos_valid"])
        valid = arrays["pos_valid"]             # the reference skips seedless classes (:125)

        coords, labels = self._build_prompts(arrays, neg_table, neg_valid,
                                             self.prompts2use1st, seg_hw, input_size)
        low_res, iou = head._decode(features, coords, labels, None, None, image_shared=True)
        if self.self_refine:
            coords, labels = self._build_prompts(arrays, neg_table, neg_valid,
                                                 self.prompts2use2nd, seg_hw, input_size)
            use_mask = torch.ones((coords.shape[0],), dtype=torch.bool, device=coords.device)
            low_res, iou = head._decode(features, coords, labels, low_res, use_mask)

        masks = postprocess_to_grid(low_res.reshape(n, c, *low_res.shape[1:]), input_size,
                                    original_size, seg_hw, img_enc_size=head.img_enc_img_size,
                                    mask_threshold=head.mask_threshold)
        refined = torch.where(valid[..., None, None], masks[:, :, 0], bool_mask)
        est_dice = torch.where(valid, jaccard_to_dice(iou[:, 0]).reshape(n, c), torch.nan)
        return refined, est_dice

    def _sizes(self, file_names: Sequence[str]):
        """(N, 2) input and (N, 2) original sizes of the named images."""
        sizes = [self.sam_predictor.sizes(f) for f in file_names]
        return tuple(torch.as_tensor(np.stack([np.asarray(s[i]) for s in sizes]),
                                     device=self.device) for i in (1, 0))

    def refine(self, seg, file_name: str):
        """(C, H, W) mask of one image -> (refined bool, est_dice (C,))."""
        seg = torch.as_tensor(seg).to(self.device)
        refined, est = self._refine_batched(seg.bool()[None],
                                            self.sam_predictor.features(file_name),
                                            *self._sizes([file_name]), tuple(seg.shape[-2:]))
        return refined[0], est[0]

    def refine_batch(self, segs, file_names: Sequence[str]):
        """(N, C, H, W) masks -> (refined (N, C, H, W) bool, est_dice (N, C)):
        the N feature maps and sizes read from the store, one batched
        refinement (JAX ``refine_batch``)."""
        segs = torch.as_tensor(segs).to(self.device)
        reader = self.sam_predictor.reader
        feats = torch.cat([torch.as_tensor(reader.features(f)).to(self.device, torch.float32)
                           for f in file_names])
        return self._refine_batched(segs.bool(), feats, *self._sizes(file_names),
                                    tuple(segs.shape[-2:]))


# ---------------------------------------------------------------------------
# Random-walk refiner (reference seg_refinement.py:119-203)
# ---------------------------------------------------------------------------


class RndWalkSegRefiner(SegRefiner):
    def __init__(self, background_erosion_radius: int, laplace_sigma: float,
                 laplace_lambda: float = 1.0, img_path: str = "data/img_only_front_all_left",
                 device=None):
        """``device``: where the walk is solved (None: the card; raises
        without one).  The image of ``file_name`` is read from ``img_path``
        and resized to the mask's grid by :meth:`_load_image`."""
        self.background_erosion_radius = background_erosion_radius
        self.laplace_lambda = laplace_lambda
        self.laplace_sigma = laplace_sigma
        self.last_input_seg = None
        self.img_path = Path(img_path)
        self.device = resolve_device(device)

    def _load_image(self, file_name: str, hw) -> np.ndarray:
        """(H, W) uint8: the grayscale PNG, bilinear to ``hw`` (cv2, as the
        reference reads it)."""
        import cv2

        img = cv2.imread(str(self.img_path / (file_name + ".png")), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(self.img_path / (file_name + ".png"))
        return cv2.resize(img, (hw[1], hw[0]))

    def refine(self, seg, file_name: str):
        """(C, H, W) mask of one image -> (refined (C, H, W) bool, None).

        The seeds are the mask's own values (the reference passes the CCL
        output, probabilities), with the background, eroded by a disk of
        ``background_erosion_radius``, as one more class; the walk's
        probabilities are thresholded at 0.5."""
        seg = torch.as_tensor(seg).to(self.device)
        self.last_input_seg = seg
        img = torch.as_tensor(self._load_image(file_name, tuple(seg.shape[-2:]))).to(self.device)
        background = ~seg.bool().any(dim=0)
        if self.background_erosion_radius > 1:
            background = erode_mask_with_disc_struct(
                background[None], radius=self.background_erosion_radius)[0]
        initial = torch.cat([background[None].to(seg.dtype), seg], dim=0)
        p_hat = random_walk_probs(img, initial, sigma=self.laplace_sigma, lam=self.laplace_lambda)
        return p_hat[1:] > 0.5, None
