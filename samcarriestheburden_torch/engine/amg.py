"""Automatic mask generation (JAX ``engine/amg.py``, reference
segment_anything/automatic_mask_generator.py).

The same algorithm in two legs per batch of grid points:

* the device leg (:meth:`SamAutomaticMaskGenerator._device_batch`): prompt
  encoding, the decode, ``postprocess_masks``, the stability score, the
  threshold, the boxes and ``packbits_device``; the logits die with the leg
  (at ViT-H, 64 points x 3 masks of 1024 x 716 are 563 MB in fp32), and the
  packed masks, scores and boxes are copied into pinned host buffers behind
  an event;
* the host leg (:meth:`SamAutomaticMaskGenerator._host_batch`): the IoU,
  stability and crop-edge filters, the uncrop (``np.pad``) and the RLE,
  numpy-backed like the JAX package's :class:`MaskData`.

:meth:`_process_crop` keeps one batch in flight: the card works on batch
i + 1 while the host filters batch i.  NMS runs as the keep mask of
``ops/nms.py`` on the model's device; small regions and RLE on the host
(``ops/regions.py``, ``ops/rle.py``, the native codec).
"""

from __future__ import annotations

from typing import Any, Dict, ItemsView, List, Optional

import numpy as np
import torch

from samcarriestheburden_torch.engine.predictor import SamPredictor
from samcarriestheburden_torch.models.sam import SamModel
from samcarriestheburden_torch.ops.mask_ops import (
    batch_iterator, batched_mask_to_box, box_xyxy_to_xywh, build_all_layer_point_grids,
    calculate_stability_score, generate_crop_boxes, is_box_near_crop_edge, packbits_device,
    unpackbits_host, uncrop_boxes_xyxy, uncrop_points)
from samcarriestheburden_torch.ops.nms import batched_nms_mask
from samcarriestheburden_torch.ops.rle import (area_from_rle, coco_encode_rle, mask_to_rle,
                                               rle_to_mask)


class MaskData:
    """Batched mask records with filter and cat (reference amg.py:16-75),
    numpy-backed."""

    def __init__(self, **kwargs) -> None:
        for v in kwargs.values():
            _check_value(v)
        self._stats: Dict[str, Any] = dict(**kwargs)

    def __setitem__(self, key, item):
        _check_value(item)
        self._stats[key] = item

    def __delitem__(self, key):
        del self._stats[key]

    def __getitem__(self, key):
        return self._stats[key]

    def items(self) -> ItemsView[str, Any]:
        return self._stats.items()

    def filter(self, keep: np.ndarray) -> None:
        for k, v in self._stats.items():
            if v is None:
                continue
            elif isinstance(v, np.ndarray):
                self._stats[k] = v[keep]
            elif isinstance(v, list) and keep.dtype == bool:
                self._stats[k] = [a for i, a in enumerate(v) if keep[i]]
            elif isinstance(v, list):
                self._stats[k] = [v[i] for i in keep]
            else:
                raise TypeError(f"cannot filter MaskData[{k!r}]: type {type(v)}")

    def cat(self, new_stats: "MaskData") -> None:
        for k, v in new_stats.items():
            if k not in self._stats or self._stats[k] is None:
                self._stats[k] = v.copy() if isinstance(v, np.ndarray) else list(v)
            elif isinstance(v, np.ndarray):
                self._stats[k] = np.concatenate([self._stats[k], v], axis=0)
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + list(v)
            else:
                raise TypeError(f"cannot concatenate MaskData[{k!r}]: type {type(v)}")

    def __len__(self):
        for v in self._stats.values():
            return len(v)
        return 0


def _check_value(v) -> None:
    if not isinstance(v, (list, np.ndarray)):
        raise TypeError("MaskData values must be lists or numpy arrays")


class _Fetched:
    """A device leg's results in host memory (pinned on the card), readable
    once ``event`` (None on the CPU) has completed."""

    def __init__(self, n, points, tensors: Dict[str, torch.Tensor], hw):
        self.n, self.points, self.hw = n, points, hw
        cuda = next(iter(tensors.values())).device.type == "cuda"
        self.host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=cuda)
                     for k, v in tensors.items()}
        for k, v in tensors.items():
            self.host[k].copy_(v, non_blocking=cuda)
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


class SamAutomaticMaskGenerator:
    def __init__(self, model: SamModel, points_per_side: Optional[int] = 32,
                 points_per_batch: int = 64, pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95, stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7, crop_n_layers: int = 0,
                 crop_nms_thresh: float = 0.7, crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1,
                 point_grids: Optional[List[np.ndarray]] = None,
                 min_mask_region_area: int = 0, output_mode: str = "binary_mask") -> None:
        """The reference's knobs and defaults (:36-134).  The work runs on
        ``model``'s device, the encoder in :class:`SamPredictor`'s default type."""
        if (points_per_side is None) == (point_grids is None):
            raise ValueError("Exactly one of points_per_side or point_grid must be provided.")
        if points_per_side is not None:
            self.point_grids = build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        else:
            self.point_grids = point_grids
        if output_mode not in ("binary_mask", "uncompressed_rle", "coco_rle"):
            raise ValueError(f"Unknown output_mode {output_mode}.")
        from samcarriestheburden_torch import native

        native.load()   # fail early: the RLE and the small-region CCL run on it

        self.predictor = SamPredictor(model)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.crop_n_points_downscale_factor = crop_n_points_downscale_factor
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode

    @property
    def device(self) -> torch.device:
        return self.predictor.device

    # ------------------------------------------------------------------

    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """image: HWC uint8.  Returns the reference's mask records (:137-195)."""
        mask_data = self._generate_masks(image)
        if self.min_mask_region_area > 0:
            mask_data = self.postprocess_small_regions(
                mask_data, self.min_mask_region_area,
                max(self.box_nms_thresh, self.crop_nms_thresh), self.device)

        if self.output_mode == "coco_rle":
            mask_data["segmentations"] = [coco_encode_rle(r) for r in mask_data["rles"]]
        elif self.output_mode == "binary_mask":
            mask_data["segmentations"] = [rle_to_mask(r) for r in mask_data["rles"]]
        else:
            mask_data["segmentations"] = mask_data["rles"]

        def xywh(a):
            return box_xyxy_to_xywh(torch.from_numpy(np.asarray(a, np.float32).reshape(-1, 4))
                                    ).numpy()

        n = len(mask_data["rles"])
        bboxes = xywh(mask_data["boxes"]) if n else []
        crop_xywh = xywh(np.asarray(mask_data["crop_boxes"])) if n else []
        return [{"segmentation": mask_data["segmentations"][i],
                 "area": area_from_rle(mask_data["rles"][i]),
                 "bbox": bboxes[i].tolist(),
                 "predicted_iou": float(mask_data["iou_preds"][i]),
                 "point_coords": [mask_data["points"][i].tolist()],
                 "stability_score": float(mask_data["stability_score"][i]),
                 "crop_box": crop_xywh[i].tolist()}
                for i in range(len(mask_data["segmentations"]))]

    def _nms_keep(self, boxes, scores, thresh: float) -> np.ndarray:
        dev = self.device
        boxes = torch.as_tensor(np.asarray(boxes, np.float32), device=dev)
        return batched_nms_mask(boxes, torch.as_tensor(np.asarray(scores, np.float32),
                                                       device=dev),
                                torch.zeros(len(boxes), dtype=torch.int32, device=dev),
                                thresh).cpu().numpy()

    def _generate_masks(self, image: np.ndarray) -> MaskData:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(orig_size, self.crop_n_layers,
                                                     self.crop_overlap_ratio)
        data = MaskData()
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            data.cat(self._process_crop(image, crop_box, layer_idx, orig_size))

        if len(crop_boxes) > 1 and len(data) > 0:
            # prefer masks from smaller crops (:210-220)
            boxes = np.asarray(data["crop_boxes"], np.float32)
            areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            data.filter(self._nms_keep(data["boxes"], 1.0 / areas, self.crop_nms_thresh))
        return data

    def _process_crop(self, image, crop_box, crop_layer_idx, orig_size) -> MaskData:
        x0, y0, x1, y1 = crop_box
        cropped_im = image[y0:y1, x0:x1, :]
        cropped_im_size = cropped_im.shape[:2]
        self.predictor.set_image(cropped_im)

        points_scale = np.array(cropped_im_size)[None, ::-1]
        points_for_image = self.point_grids[crop_layer_idx] * points_scale

        data = MaskData()
        in_flight = None            # the card runs batch i + 1 while the host filters batch i
        for (points,) in batch_iterator(self.points_per_batch, points_for_image):
            fetched = self._device_batch(points, cropped_im_size)
            if in_flight is not None:
                data.cat(self._host_batch(in_flight, crop_box, orig_size))
            in_flight = fetched
        if in_flight is not None:
            data.cat(self._host_batch(in_flight, crop_box, orig_size))
        self.predictor.reset_image()

        if len(data) > 0:
            data.filter(self._nms_keep(data["boxes"], data["iou_preds"], self.box_nms_thresh))
        data["boxes"] = uncrop_boxes_xyxy(torch.from_numpy(data["boxes"]), crop_box).numpy()
        # fp32 points, as the JAX package's (its arrays are 32-bit)
        data["points"] = uncrop_points(torch.from_numpy(data["points"]).float(),
                                       crop_box).numpy()
        data["crop_boxes"] = [crop_box for _ in range(len(data["rles"]))]
        return data

    def _process_batch(self, points, im_size, crop_box, orig_size) -> MaskData:
        """One batch of crop-frame points through both legs (JAX ``_process_batch``)."""
        return self._host_batch(self._device_batch(points, im_size), crop_box, orig_size)

    @torch.no_grad()
    def _device_batch(self, points: np.ndarray, im_size) -> _Fetched:
        """Decode the points (the last short batch padded to
        ``points_per_batch``, so every batch has one shape), score, threshold
        and pack the masks; the results start their copy to the host."""
        n = len(points)
        pad = self.points_per_batch - n
        if pad > 0:
            points = np.concatenate([points, np.zeros((pad, 2))], axis=0)
        transformed = self.predictor.transform.apply_coords(points, im_size)
        dev = self.device
        masks, iou_preds, _ = self.predictor.predict_batched(
            torch.from_numpy(transformed[:, None, :]).to(dev),
            torch.ones((len(points), 1), dtype=torch.int32, device=dev),
            multimask_output=True, return_logits=True)
        thr = self.predictor.model.mask_threshold
        stability = calculate_stability_score(masks, thr, self.stability_score_offset)
        bin_masks = masks > thr
        del masks
        boxes = batched_mask_to_box(bin_masks)
        hw = tuple(bin_masks.shape[-2:])
        wpad = (-hw[1]) % 8
        packed = packbits_device(torch.nn.functional.pad(bin_masks, (0, wpad)))
        del bin_masks
        return _Fetched(n, points[:n], {"packed": packed, "iou_preds": iou_preds,
                                        "stability_score": stability, "boxes": boxes}, hw)

    def _host_batch(self, fetched: _Fetched, crop_box, orig_size) -> MaskData:
        """Flatten (B, 3) to records, drop the padding, filter by IoU,
        stability and crop edge, uncrop and RLE-encode the survivors."""
        orig_h, orig_w = orig_size
        got = fetched.wait()
        per_point = got["iou_preds"].shape[1]
        rows = slice(0, fetched.n * per_point)
        data = MaskData(
            packed=got["packed"].reshape(-1, *got["packed"].shape[2:])[rows],
            iou_preds=got["iou_preds"].reshape(-1)[rows].copy(),
            stability_score=got["stability_score"].reshape(-1)[rows].copy(),
            boxes=got["boxes"].reshape(-1, 4)[rows].copy(),
            points=fetched.points.repeat(per_point, axis=0))
        if self.pred_iou_thresh > 0.0:
            data.filter(data["iou_preds"] > self.pred_iou_thresh)
        if self.stability_score_thresh > 0.0:
            data.filter(data["stability_score"] >= self.stability_score_thresh)
        keep = ~is_box_near_crop_edge(torch.from_numpy(data["boxes"]), crop_box,
                                      [0, 0, orig_w, orig_h]).numpy()
        if not keep.all():
            data.filter(keep)

        # the survivors only are unpacked; the uncrop is a zero pad on the host
        masks = unpackbits_host(data["packed"], fetched.hw[1])
        del data["packed"]
        x0, y0, x1, y1 = crop_box
        if (x0, y0, x1, y1) != (0, 0, orig_w, orig_h):
            masks = np.pad(masks, ((0, 0), (y0, orig_h - y1), (x0, orig_w - x1)))
        data["rles"] = mask_to_rle(masks)
        return data

    # ------------------------------------------------------------------

    @staticmethod
    def postprocess_small_regions(mask_data: MaskData, min_area: int, nms_thresh: float,
                                  device=None) -> MaskData:
        """Hole and island removal, then NMS again (reference :323-372), on
        the host through ``ops/regions.py``; the NMS on ``device`` (None:
        the card)."""
        from samcarriestheburden_torch.device import resolve_device
        from samcarriestheburden_torch.ops.regions import remove_small_regions

        if len(mask_data["rles"]) == 0:
            return mask_data
        new_masks, scores = [], []
        for rle in mask_data["rles"]:
            mask = rle_to_mask(rle)
            mask, changed = remove_small_regions(mask, min_area, mode="holes")
            unchanged = not changed
            mask, changed = remove_small_regions(mask, min_area, mode="islands")
            unchanged = unchanged and not changed
            new_masks.append(mask[None])
            scores.append(float(unchanged))

        dev = resolve_device(device)
        masks = torch.from_numpy(np.concatenate(new_masks, axis=0)).to(dev)
        boxes_d = batched_mask_to_box(masks)
        keep = batched_nms_mask(boxes_d.float(), torch.tensor(scores, device=dev),
                                torch.zeros(len(masks), dtype=torch.int32, device=dev),
                                nms_thresh).cpu().numpy()
        boxes = boxes_d.cpu().numpy()
        masks = masks.cpu().numpy()
        for i_mask in np.flatnonzero(keep):
            if scores[i_mask] == 0.0:  # recompute only the changed masks
                mask_data["rles"][i_mask] = mask_to_rle(masks[i_mask][None])[0]
                mask_data["boxes"][i_mask] = boxes[i_mask]
        mask_data.filter(keep)
        return mask_data
