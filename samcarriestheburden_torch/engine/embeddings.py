"""Batched SAM image embeddings (JAX ``engine/embeddings.py``).

Images arrive resized-longest-side on the host and zero-padded into a fixed
(B, 3, S, S) uint8 batch with their (B, 2) input sizes; normalisation and the
padding mask run on the device, so the encoder always sees one shape
(normalise-then-pad, reference sam.py:164-174).  The MedSAM variant takes
images resized to the square encoder size and normalises each to [0, 1] by
its own minimum and maximum.

Every entry point takes ``compact_windows``: ``None`` (the default) or
``True`` runs the compact ragged-window layout, as the JAX package serves
on its accelerator; ``False`` the flat layout with its pad tokens.

The encoder's other block formulations are chosen with JAX ``apply``'s
keywords, handed on to ``ImageEncoderViT.forward``: ``fused_qkv=False`` with
``attention_impl`` (v1: K9 through ``attention_apply_kernel``),
``fused_window_blocks=True`` (v2: K12), ``persistent_windows=False``.  As in
the JAX package the fused flags are on where there is an accelerator, so
``attention_impl`` alone changes nothing on the serving default: the flat and
compact paths never call it.

``unroll_blocks`` (JAX: inline the windowed layers instead of ``lax.scan``)
is accepted and unused by every entry point: eager PyTorch runs the layers
one after the other either way, and the JAX package's outputs are the same
both ways.

:func:`precompute_embeddings` encodes image files into the embeddings h5
(JAX ``precompute_embeddings``); its loop over batches is
:func:`encode_images`, which takes decoded images and any writer.  In a
group of several processes each encodes its strided shard into a part file,
which :func:`merge_embedding_shards` merges.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from samcarriestheburden_torch.data.h5io import EmbeddingWriter
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.models.image_encoder import (EncoderOps, attention_apply,
                                                            attention_apply_kernel, default_ops)
from samcarriestheburden_torch.models.quantize import prequantize_sam
from samcarriestheburden_torch.models.sam import SamModel
from samcarriestheburden_torch.ops.resize import resize_longest_side_np
from samcarriestheburden_torch.profiling import active, count, span

Packed = List[Dict[str, torch.Tensor]]


def default_attention_impl() -> Callable:
    """The ``attention_impl`` of the unfused formulation: K9 behind
    :func:`attention_apply_kernel` where there is a card, the plain
    :func:`attention_apply` elsewhere (JAX ``default_attention_impl``)."""
    return attention_apply_kernel if torch.cuda.is_available() else attention_apply


def make_encode_batch(model: SamModel, dtype=torch.bfloat16, *,
                      attention_impl: Optional[Callable] = None,
                      quantize: Optional[str] = None,
                      compact_windows: Optional[bool] = None,
                      ops: Optional[EncoderOps] = None,
                      fused_qkv: bool = True, fused_mlp: bool = True,
                      fused_window_blocks: bool = False,
                      persistent_windows: bool = True,
                      unroll_blocks: Optional[bool] = None) -> Callable:
    """``encode(packed, imgs, input_sizes)``: (B, 3, S, S) uint8 + (B, 2)
    int sizes -> (B, 256, G, G) fp32 embeddings, on the model's device.
    ``packed`` is ``model.image_encoder.pack(dtype, quantize)``;
    ``quantize="int8"`` selects the int8 serving mode (K2, K4, K7-int8 over
    prequantized weights).  ``ops`` overrides the mode's kernel wrappers.
    ``attention_impl`` (None: :func:`default_attention_impl`) and the four
    flags after it choose the block formulation
    (``ImageEncoderViT.forward``); with the flags as they are, the serving
    default, no block calls ``attention_impl``."""
    size = model.img_size
    if ops is None:
        ops = default_ops(quantize)
    compact = compact_windows is None or bool(compact_windows)
    variant = dict(attention_impl=attention_impl or default_attention_impl(),
                   fused_qkv=fused_qkv, fused_mlp=fused_mlp,
                   fused_window_blocks=fused_window_blocks,
                   persistent_windows=persistent_windows)

    @torch.no_grad()
    def encode(packed: Packed, imgs: torch.Tensor, input_sizes: torch.Tensor) -> torch.Tensor:
        dev = model.device
        imgs = imgs.to(dev)
        input_sizes = input_sizes.to(dev)
        ih = torch.arange(size, device=dev)
        valid = ((ih[None, :, None] < input_sizes[:, 0, None, None])
                 & (ih[None, None, :] < input_sizes[:, 1, None, None]))
        x = (imgs.float() - model.pixel_mean) / model.pixel_std
        x = x * valid[:, None]
        return model.image_encoder(x, dtype=dtype, packed=packed, ops=ops,
                                   compact_windows=compact, **variant)

    return encode


def make_encode_batch_medsam(model: SamModel, dtype=torch.bfloat16, *,
                             quantize: Optional[str] = None,
                             compact_windows: Optional[bool] = None,
                             unroll_blocks: Optional[bool] = None) -> Callable:
    """The MedSAM variant of :func:`make_encode_batch` (JAX
    ``make_encode_batch_medsam``): the (B, 3, S, S) images arrive resized to
    the square encoder size and each is normalised to [0, 1] by its own
    minimum and maximum, with no padding mask (``input_sizes`` is accepted
    and ignored).  The encoder stack, ``quantize`` and ``compact_windows``
    are the same."""
    ops = default_ops(quantize)
    compact = compact_windows is None or bool(compact_windows)

    @torch.no_grad()
    def encode(packed: Packed, imgs: torch.Tensor, input_sizes=None) -> torch.Tensor:
        x = imgs.to(model.device).float()
        lo = x.amin(dim=(1, 2, 3), keepdim=True)
        hi = x.amax(dim=(1, 2, 3), keepdim=True)
        x = (x - lo) / (hi - lo).clamp(min=1e-8)
        return model.image_encoder(x, dtype=dtype, packed=packed, ops=ops,
                                   compact_windows=compact)

    return encode


def make_serving_encoder(model: SamModel, dtype=torch.bfloat16,
                         quantize: Optional[str] = None, *, medsam: bool = False,
                         compact_windows: Optional[bool] = None,
                         attention_impl: Optional[Callable] = None,
                         unroll_blocks: Optional[bool] = None,
                         **variant) -> Tuple[Callable, Packed]:
    """(encode_fn, ready-to-serve weights) for the batched encoder: the
    weights are packed once into the kernels' layout and types, outside the
    serving loop, and every call reuses them.  With ``quantize="int8"`` that
    one pass also prequantizes the encoder's matrices
    (``models/quantize.py:prequantize_sam``), so no call quantizes a weight.
    ``medsam`` selects the MedSAM preprocessing over the same stack.
    ``attention_impl`` and ``variant`` (``fused_qkv``, ``fused_mlp``,
    ``fused_window_blocks``, ``persistent_windows``, ``ops``) go to
    :func:`make_encode_batch`; the MedSAM variant, as in the JAX package,
    runs the serving formulation only."""
    if medsam:
        if attention_impl is not None or variant:
            raise ValueError("the MedSAM encode runs the serving block formulation only")
        encode = make_encode_batch_medsam(model, dtype, quantize=quantize,
                                          compact_windows=compact_windows)
    else:
        encode = make_encode_batch(model, dtype, attention_impl=attention_impl,
                                   quantize=quantize, compact_windows=compact_windows,
                                   **variant)
    if quantize == "int8":
        return encode, prequantize_sam(model, dtype)
    return encode, model.image_encoder.pack(dtype)


def load_image_gray(path) -> np.ndarray:
    """Grayscale PNG -> HW uint8 (reference generate_img_embeddings.py:39)."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


def load_image_rgb(path) -> np.ndarray:
    """Grayscale PNG -> HWC RGB uint8, the gray value in three channels
    (``cv2.COLOR_GRAY2RGB``; reference generate_img_embeddings.py:39-40)."""
    return np.repeat(load_image_gray(path)[..., None], 3, axis=2)


def encode_images(encode: Callable, packed: Packed, stems: Sequence[str],
                  read: Callable[[str], np.ndarray], writer, *, img_size: int, device=None,
                  batch_size: int = 8, medsam: bool = False,
                  loader_threads: Optional[int] = None, progress: bool = False) -> None:
    """Encode the images ``read(stem)`` (HWC RGB or HW grayscale uint8) in
    fixed batches of ``batch_size`` (the last one padded) and hand each
    embedding to ``writer.write(stem, features (1, C, G, G), original_size,
    input_size)``.

    ``encode``, ``packed``: a :func:`make_serving_encoder` pair on
    ``device`` (None: the card; raises without one).  The host decodes and
    resizes (resize-longest-side, or with ``medsam`` cv2's cubic square
    resize) in ``loader_threads`` threads (default ``min(8, cpu_count)``),
    one batch ahead.  A grayscale image is resized once and fed in three
    equal channels: the bits its RGB conversion would give, at a third of
    the host's work, which the encoder's launches on the main thread compete
    with.  On the card the loop is a software pipeline: batch i is copied up
    from a pinned buffer, encoded and copied back into one of two pinned
    output buffers on a stream of its own, and an event marks its end; while
    the card works on it, the host writes batch i-1, once that batch's event
    has completed, and gathers batch i+1.  Spans (``profiling.span``, each
    with ``batch``): ``encode_images.load_wait`` (batch i's loader results
    into the pinned buffer; the counter ``encode_images.batches_waited``
    counts the batches whose loads had not all finished when the loop
    reached them), ``encode_images.dispatch`` (the encode and the copy
    back enqueued), ``encode_images.drain`` (the wait for batch i-1's event
    and its writes)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    loader_threads = loader_threads or min(8, os.cpu_count() or 1)
    stream = torch.cuda.Stream(dev) if cuda else None
    if cuda:        # the weights were made on the current stream
        stream.wait_stream(torch.cuda.current_stream(dev))

    def load_one(stem):
        img = read(stem)
        if medsam:
            import cv2

            resized = cv2.resize(img, (img_size, img_size), interpolation=cv2.INTER_CUBIC)
        else:
            resized = resize_longest_side_np(img, img_size)
        chw = resized[None] if resized.ndim == 2 else resized.transpose(2, 0, 1)
        return chw, resized.shape[:2], img.shape[:2]

    # two of each host buffer: batch i's copies may still run while batch
    # i+1 is gathered and batch i-1 is written
    inputs = [(torch.zeros((batch_size, 3, img_size, img_size), dtype=torch.uint8,
                           pin_memory=cuda),
               torch.ones((batch_size, 2), dtype=torch.int32, pin_memory=cuda))
              for _ in range(2)]
    outputs: List[Optional[torch.Tensor]] = [None, None]

    def drain(pending, batch):
        chunk, in_sizes, orig_sizes, feats, done = pending
        with span("encode_images.drain", batch=batch):
            if done is not None:
                done.synchronize()
            for i, stem in enumerate(chunk):
                writer.write(stem, feats[i:i + 1].numpy(), orig_sizes[i], in_sizes[i])

    starts = list(range(0, len(stems), batch_size))
    it = starts
    if progress:
        from tqdm import tqdm

        it = tqdm(starts, unit="batch", desc="Saving embeddings")
    with ThreadPoolExecutor(loader_threads) as pool:
        futs = [pool.submit(load_one, s) for s in stems[:batch_size]]
        pending = None
        for idx, start in enumerate(it):
            chunk = stems[start:start + batch_size]
            imgs_h, sizes_h = inputs[idx % 2]
            with span("encode_images.load_wait", batch=idx):
                if active() and not all(fut.done() for fut in futs):
                    count("encode_images.batches_waited")
                imgs_h.zero_()
                sizes_h.fill_(1)
                in_sizes, orig_sizes = [], []
                for i, fut in enumerate(futs):
                    chw, (h, w), orig = fut.result()
                    imgs_h[i, :, :h, :w] = torch.from_numpy(chw)
                    sizes_h[i, 0], sizes_h[i, 1] = h, w
                    in_sizes.append((h, w))
                    orig_sizes.append(orig)
                futs = [pool.submit(load_one, s)
                        for s in stems[start + batch_size:start + 2 * batch_size]]
            with span("encode_images.dispatch", batch=idx), \
                    (torch.cuda.stream(stream) if cuda else contextlib.nullcontext()):
                feats = encode(packed, imgs_h.to(dev, non_blocking=True),
                               sizes_h.to(dev, non_blocking=True))
                if outputs[idx % 2] is None:
                    outputs[idx % 2] = torch.empty(feats.shape, dtype=torch.float32,
                                                   pin_memory=cuda)
                out_h = outputs[idx % 2].copy_(feats, non_blocking=True)
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record(stream)
            if pending is not None:
                drain(pending, idx - 1)
            pending = (chunk, in_sizes, orig_sizes, out_h, done)
        if pending is not None:
            drain(pending, idx)


def precompute_embeddings(model: SamModel, image_files: Sequence, out_h5, checkpoint_name: str,
                          *, batch_size: int = 8, dtype=torch.bfloat16,
                          progress: bool = True, medsam: bool = False, resume: bool = False,
                          quantize: Optional[str] = None,
                          unroll_blocks: bool = False,
                          loader_threads: Optional[int] = None) -> None:
    """Encode every image file (grayscale PNG) with the serving encoder on the
    model's device and write the embeddings h5 (JAX
    ``precompute_embeddings``): :func:`encode_images` over
    :func:`load_image_gray` into an :class:`EmbeddingWriter`.

    ``medsam=True`` switches to the MedSAM preprocessing (cv2 cubic square
    resize, per-image min-max normalisation; reference
    generate_img_embeddings.py:49-64).  ``resume=True`` reopens an
    interrupted run and skips the stems already stored.
    ``quantize="int8"`` selects the int8 serving mode; ``unroll_blocks`` is
    accepted and has no effect (module docstring).

    Multi-process: in a ``torch.distributed`` group of more than one
    process, each process encodes its strided slice of the file list
    (``parallel/distributed.py:process_shard``) on its own card (image
    encoding needs no collective) and writes ``<out>.part<rank>`` with the
    ``shard_count`` attribute; merge them afterwards with
    :func:`merge_embedding_shards`.  JAX's ``mesh`` argument has no
    counterpart: the port runs one card per process, so a process's batch
    is never split over devices."""
    from samcarriestheburden_torch.parallel import distributed as pdist

    shard_count = None
    if pdist.is_multiprocess():
        image_files = pdist.process_shard(image_files)
        out_h5 = Path(f"{out_h5}.part{pdist.process_index()}")
        shard_count = pdist.process_count()    # provenance for the merge's guard
    encode, packed = make_serving_encoder(model, dtype, quantize=quantize, medsam=medsam)
    files = {Path(f).stem: Path(f) for f in image_files}
    with EmbeddingWriter(out_h5, checkpoint_name, model.img_size, append=resume) as writer:
        if shard_count is not None:
            writer.f.attrs["shard_count"] = shard_count
        done = writer.existing_stems() if resume else set()
        encode_images(encode, packed, [s for s in files if s not in done],
                      lambda stem: load_image_gray(files[stem]), writer,
                      img_size=model.img_size, device=model.device, batch_size=batch_size,
                      medsam=medsam, loader_threads=loader_threads,
                      progress=progress)


def merge_embedding_shards(out_h5, n_processes: int = None, delete_parts: bool = False) -> Path:
    """Merge the per-process ``<out>.part<p>`` files of a multi-process
    precompute into one embeddings h5 (same schema, attrs copied from part
    0; JAX ``merge_embedding_shards``).  Run in one process after every
    process has finished."""
    from samcarriestheburden_torch.data.h5io import merge_h5_shards

    return merge_h5_shards(out_h5, "img_embedding", "checkpoint",
                           n_processes=n_processes, delete_parts=delete_parts)
