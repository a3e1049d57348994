"""The exportable decoder program (JAX ``export/stablehlo.py``; reference
segment_anything/utils/onnx.py and scripts/export_onnx_model.py).

The reference traces the prompt encoder, the mask decoder and the
postprocess to ONNX with dynamic point counts.  The JAX package serialises
the same program as StableHLO through ``jax.export``; the port writes a
``torch.export`` artifact (``.pt2``, :func:`torch.export.save`) with
symbolic batch and point axes, which :func:`load_exported` gives back as a
callable module.

Semantics mirrored from SamOnnxModel, as in the JAX program:

* branch-free point and mask embedding (labels -1..3, the
  ``has_mask_input`` gate);
* best-mask selection by the (num_points - 2.5) score reweighting;
* optional stability scores in place of the IoU scores.

The program returns masks in the fixed img_size^2 frame with the size before
padding (the reference's ``resize_longest_image_size``); the crop and the
resize to the original frame are the consumer's.

Weight modes (:func:`quantize_state_dict`): ``bf16`` stores every fp32
tensor as bf16; ``int8`` stores each tensor of two or more dims and more
than 1024 elements as per-tensor symmetric int8 with an fp32 scale.  The
quantized tensors are the artifact's buffers, dequantized in the program.

The artifact is bound to the device it was exported on: the constants the
program makes (the coordinate normaliser, the positional grid, the
reweight row) are traced there.  Export on the device it will run on.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Dict, Optional, Union

import torch
from torch import nn

from samcarriestheburden_torch.ops.mask_ops import calculate_stability_score
from samcarriestheburden_torch.ops.resize import resize_bilinear

#: the SamOnnxModel input interface, in positional order
INPUT_NAMES = ("image_embeddings", "point_coords", "point_labels", "mask_input",
               "has_mask_input", "orig_im_size")

#: a quantized tensor's gate: two dims or more and more than this many elements
QUANTIZE_MIN_SIZE = 1024

#: the hypernetwork MLPs, one per mask token here, are one stacked tensor per
#: layer in the JAX package's tree; the int8 mode quantizes each stack as one
_HYPER = re.compile(r"^(mask_decoder\.output_hypernetworks_mlps\.)\d+(\.layers\.\d+\.weight)$")


def resize_longest_image_size(input_image_size: torch.Tensor, longest_side: int) -> torch.Tensor:
    """(2,) original size -> (2,) int32 size after resize-longest-side
    (reference onnx.py:41-49)."""
    size = input_image_size.float()
    scale = longest_side / size.max()
    return torch.floor(scale * size + 0.5).to(torch.int32)


class DecoderProgram(nn.Module):
    """``forward(image_embeddings, point_coords, point_labels, mask_input,
    has_mask_input, orig_im_size)`` mirroring SamOnnxModel.forward (JAX
    ``make_decoder_fn``) on the model's prompt encoder and mask decoder
    (fp32).  Returns ``(upscaled, prepadded, scores, masks)``, with
    ``stability`` and ``areas`` before ``masks`` when
    ``return_extra_metrics``."""

    def __init__(self, model, return_single_mask: bool, use_stability_score: bool = False,
                 return_extra_metrics: bool = False, stability_score_offset: float = 1.0):
        super().__init__()
        self.prompt_encoder = model.prompt_encoder
        self.mask_decoder = model.mask_decoder
        self.img_size = model.img_size
        self.mask_threshold = model.mask_threshold
        self.return_single_mask = return_single_mask
        self.use_stability_score = use_stability_score
        self.return_extra_metrics = return_extra_metrics
        self.stability_score_offset = stability_score_offset

    def forward(self, image_embeddings, point_coords, point_labels, mask_input, has_mask_input,
                orig_im_size):
        pe = self.prompt_encoder
        sparse = pe.embed_unified_points(point_coords, point_labels)
        dense = pe.embed_masks_or_default(mask_input, has_mask_input.reshape(-1).bool())
        image_pe = pe.get_dense_pe()
        masks, scores = self.mask_decoder.predict_masks(image_embeddings, image_pe, sparse, dense)

        if self.use_stability_score:
            scores = calculate_stability_score(masks, self.mask_threshold,
                                               self.stability_score_offset).to(scores.dtype)

        if self.return_single_mask:
            nt = masks.shape[1]
            reweight = torch.tensor([[1000.0] + [0.0] * (nt - 1)], device=scores.device)
            # the point count as a tensor of the size: no guard on a symbolic n
            num_points = torch.scalar_tensor(point_coords.shape[1], dtype=torch.float32,
                                             device=scores.device)
            best = (scores + (num_points - 2.5) * reweight).argmax(dim=1)
            masks = masks.gather(1, best[:, None, None, None].expand(-1, 1, *masks.shape[2:]))
            scores = scores.gather(1, best[:, None])

        upscaled = resize_bilinear(masks, (self.img_size, self.img_size))
        prepadded = resize_longest_image_size(orig_im_size, self.img_size)

        if self.return_extra_metrics:
            stability = calculate_stability_score(upscaled, self.mask_threshold,
                                                  self.stability_score_offset)
            areas = (upscaled > self.mask_threshold).sum(dim=(-1, -2), dtype=torch.int32)
            return upscaled, prepadded, scores, stability, areas, masks
        return upscaled, prepadded, scores, masks


def make_decoder_fn(model, return_single_mask: bool, use_stability_score: bool = False,
                    return_extra_metrics: bool = False,
                    stability_score_offset: float = 1.0) -> DecoderProgram:
    """The decoder program of ``model`` (a :class:`SamModel`) as an
    ``nn.Module`` sharing its weights."""
    return DecoderProgram(model, return_single_mask, use_stability_score, return_extra_metrics,
                          stability_score_offset).eval()


Quantized = Union[torch.Tensor, Dict[str, torch.Tensor]]


def quantize_state_dict(sd: Dict[str, torch.Tensor], mode: str) -> Dict[str, Quantized]:
    """Weight quantization for export (JAX ``quantize_params``).

    ``bf16``: every fp32 tensor as bf16.  ``int8``: each fp32 tensor of two
    dims or more and more than :data:`QUANTIZE_MIN_SIZE` elements becomes
    ``{"q": int8, "s": fp32 scale}``, the scale max(absmax, 1e-12) / 127 and
    ``q = clip(round(x / s), -127, 127)`` (round half to even), as the JAX
    package computes them eagerly.  The hypernetwork MLPs' weights of one
    layer are quantized together, as the one stacked tensor they are in the
    JAX tree, so both packages dequantize to the same bits."""
    if mode == "bf16":
        return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v for k, v in sd.items()}
    if mode != "int8":
        raise ValueError(f"unknown quantization mode {mode!r}")
    groups: Dict[str, list] = {}
    for k in sd:
        groups.setdefault(_HYPER.sub(r"\1*\2", k), []).append(k)
    out: Dict[str, Quantized] = {}
    for names in groups.values():
        ts = [sd[k] for k in names]
        if ts[0].dtype != torch.float32 or ts[0].ndim < 2 \
                or sum(t.numel() for t in ts) <= QUANTIZE_MIN_SIZE:
            out.update(zip(names, ts))
            continue
        absmax = torch.stack([t.abs().max() for t in ts]).max()
        scale = torch.clamp(absmax, min=1e-12) / 127.0
        for k, t in zip(names, ts):
            out[k] = {"q": torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8),
                      "s": scale}
    return {k: out[k] for k in sd}


def dequantize_state_dict(qsd: Dict[str, Quantized]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`quantize_state_dict`: fp32 tensors
    (``s * float(q)``, bf16 cast up)."""
    return {k: v["s"] * v["q"].float() if isinstance(v, dict)
            else v.float() if v.dtype == torch.bfloat16 else v
            for k, v in qsd.items()}


class QuantizedProgram(nn.Module):
    """A :class:`DecoderProgram` over quantized weights: the quantized
    tensors are this module's buffers, dequantized in ``forward`` and handed
    to the program through ``torch.func.functional_call``.  The program's
    own weights are on the meta device and outside the module tree, so an
    export saves the quantized tensors alone."""

    def __init__(self, program: DecoderProgram, mode: str):
        super().__init__()
        qsd = quantize_state_dict(program.state_dict(), mode)
        self._program = (copy.deepcopy(program).to("meta"),)
        self._keys = []
        for name, v in qsd.items():
            key = name.replace(".", "__")
            if isinstance(v, dict):
                self.register_buffer(key + "__q", v["q"].clone())
                self.register_buffer(key + "__s", v["s"].clone())
            else:
                self.register_buffer(key, v.clone())
            self._keys.append((name, key, isinstance(v, dict)))

    def quantized(self) -> Dict[str, Quantized]:
        return {name: {"q": getattr(self, key + "__q"), "s": getattr(self, key + "__s")}
                if q else getattr(self, key) for name, key, q in self._keys}

    def forward(self, image_embeddings, point_coords, point_labels, mask_input, has_mask_input,
                orig_im_size):
        args = (image_embeddings, point_coords, point_labels, mask_input, has_mask_input,
                orig_im_size)
        return torch.func.functional_call(self._program[0],
                                          dequantize_state_dict(self.quantized()), args)


def example_inputs(model, b: int, n: int, device) -> tuple:
    """Inputs of the program's shapes and dtypes (JAX ``export_decoder``'s
    ``ShapeDtypeStruct``s): embeddings (1, C, H, W) fp32, coords (b, n, 2)
    fp32, labels (b, n) int32, mask (b, 1, 4H, 4W) fp32, has_mask_input (b,)
    fp32, orig_im_size (2,) int32."""
    cfg = model.cfg
    eh, ew = cfg.prompt_encoder.image_embedding_size
    td = cfg.mask_decoder.transformer_dim
    gen = torch.Generator().manual_seed(0)
    return (torch.randn((1, td, eh, ew), generator=gen).to(device),
            (torch.rand((b, n, 2), generator=gen) * model.img_size).to(device),
            torch.ones((b, n), dtype=torch.int32, device=device),
            torch.zeros((b, 1, 4 * eh, 4 * ew), device=device),
            torch.zeros((b,), device=device),
            torch.tensor([600, 800], dtype=torch.int32, device=device))


def export_program(model, *, return_single_mask: bool, use_stability_score: bool = False,
                   return_extra_metrics: bool = False, batch: Optional[int] = None,
                   num_points: Optional[int] = None, quantize: Optional[str] = None):
    """The decoder program of ``model`` through ``torch.export`` on the
    model's device: an ``ExportedProgram``.  ``batch`` or ``num_points``
    None gives a symbolic axis (traced at 2: ``torch.export`` specialises
    sizes 0 and 1)."""
    from torch.export import Dim, export

    program = make_decoder_fn(model, return_single_mask, use_stability_score,
                              return_extra_metrics)
    module = program if quantize is None else QuantizedProgram(program, quantize).eval()
    b = Dim("b", min=1) if batch is None else None
    n = Dim("n", min=1) if num_points is None else None
    args = example_inputs(model, batch or 2, num_points or 2, model.device)
    dynamic = ({}, {0: b, 1: n}, {0: b, 1: n}, {0: b}, {0: b}, {})
    dynamic = tuple({ax: d for ax, d in spec.items() if d is not None} or None
                    for spec in dynamic)
    with torch.no_grad():
        return export(module, args, dynamic_shapes=dynamic, strict=False)


def export_decoder(model, out_path, *, return_single_mask: bool,
                   use_stability_score: bool = False, return_extra_metrics: bool = False,
                   batch: Optional[int] = None, num_points: Optional[int] = None,
                   quantize: Optional[str] = None) -> Path:
    """Write the decoder program (:func:`export_program`) to ``out_path``
    (``torch.export.save``, a ``.pt2`` artifact)."""
    exported = export_program(model, return_single_mask=return_single_mask,
                              use_stability_score=use_stability_score,
                              return_extra_metrics=return_extra_metrics, batch=batch,
                              num_points=num_points, quantize=quantize)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, out_path)
    return out_path


def load_exported(path):
    """A saved decoder artifact as a callable module (the reference's
    onnxruntime round trip, export_onnx_model.py:161-167)."""
    return torch.export.load(Path(path)).module()
