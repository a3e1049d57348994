"""Embedding precompute: the program's ``engine/embeddings.py:encode_images``
(loader threads resize on the host, pinned buffers, a copy stream, the
writer one batch late) over a stream of X-ray-like images held decoded in
memory, with the serving encoder of ``make_serving_encoder`` (``quantize``
from the mix), into an in-memory store.

The window (``harness/core.py:BatchStore``) starts when the first batch
has been written and ends at the first batch written after ``seconds``;
its work is the images of the batches written in between.  The pool holds
more images than the sampled batches reach, so no two of those batches
hold the same images.  Correctness: a sample of the window's images,
drawn from the seed, is encoded again by the plain float32 ViT
(``reference/sam.py``) from the same decoded image, and the embeddings are
compared by their relative L2 distance.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import synth
from harness.core import BatchStore, Check, Names, StopWindow, Window, judge
from harness.models import full_fp32, port_sam_config, reference_sam, seeded
from reference import sam as ref_sam
from reference.resize import resize_longest_side_np


@dataclass
class State:
    encode: object
    packed: object
    pool: List[np.ndarray]
    img_size: int
    batch: int
    calls: int = 0
    store: Optional[BatchStore] = None
    launches: Dict[str, int] = field(default_factory=dict)
    keep: List[int] = field(default_factory=list)
    readings: Dict[str, float] = field(default_factory=dict)


def _run(state: State, ctx, store, n_images: int = 10 ** 7) -> None:
    """``encode_images`` over images 0 .. n_images - 1 of the cycled pool,
    or until the store closes the window."""
    from samcarriestheburden_torch.engine.embeddings import encode_images

    spans, encode_fn, pool = ctx.spans, state.encode, state.pool

    def encode(packed, imgs, sizes):
        state.calls += 1
        with spans("models.encode"):
            return encode_fn(packed, imgs, sizes)

    try:
        with spans("loops.encode_images"):
            encode_images(encode, state.packed, Names(str, n_images),
                          lambda stem: pool[int(stem) % len(pool)], store,
                          img_size=state.img_size, device=ctx.device, batch_size=state.batch,
                          loader_threads=ctx.traffic["loader_threads"])
    except StopWindow:
        pass
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()


def setup(ctx) -> State:
    from samcarriestheburden_torch.engine.embeddings import make_serving_encoder
    from samcarriestheburden_torch.models.sam import build_sam

    c, t = ctx.config, ctx.traffic
    dev = ctx.device
    _, sd = seeded(lambda: ref_sam.Sam(c), ctx.subseed("weights"), dev)
    model = build_sam(port_sam_config(c), device=dev, state_dict=sd)
    del sd, _
    dtype = getattr(torch, t["dtype"])
    encode, packed = make_serving_encoder(model, dtype, quantize=t["quantize"])
    n, chunk = t["pool"], t["draw_chunk"]
    pool = [img for i in range(0, n, chunk)
            for img in synth.xrays(ctx.subseed(f"images{i}"), min(chunk, n - i), t["image_hw"],
                                   dev).cpu().numpy()]
    state = State(encode, packed, pool, c["image_size"], t["batch_size"])
    rng = np.random.default_rng(ctx.subseed("sample"))
    b = t["batch_size"]
    state.keep = sorted(rng.choice(np.arange(b, b * (1 + t["check_within_batches"])),
                                   t["check_images"], replace=False).tolist())
    _run(state, ctx, BatchStore(b, float("inf"), -1, ctx.spans), b * t["warmup_batches"])
    return state


def window(state: State, ctx, seconds: float) -> Window:
    from samcarriestheburden_torch.kernels import LAUNCHES

    b = state.batch
    before = dict(LAUNCHES)
    state.calls = 0
    keep = set(state.keep)

    def take(n, stem, features, original_size, input_size):
        k = int(stem)
        return (k, np.array(features[0], np.float32)) if k in keep else None

    state.store = store = BatchStore(b, seconds, max(keep), ctx.spans, take)
    _run(state, ctx, store)
    state.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    return store.window(encode_calls=state.calls)


def release(state: State) -> None:
    state.encode = state.packed = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_embeddings(ctx, state: State, bits: Optional[int] = None) -> Dict[int, np.ndarray]:
    """The plain ViT's embeddings of the sampled images (``bits``: the
    matrices and their inputs quantized to that many bits, the control)."""
    c = ctx.config
    model = reference_sam(c, ctx.subseed("weights"), ctx.device)
    out = {}
    with torch.no_grad(), full_fp32():
        for k in state.keep:
            img = resize_longest_side_np(state.pool[k % len(state.pool)], c["image_size"])
            x = torch.from_numpy(np.repeat(img[None, None], 3, axis=1)).to(ctx.device)
            out[k] = model.encode(x, img.shape, bits)[0].float().cpu().numpy()
    del model
    return out


def compare(produced: Dict[int, np.ndarray], ref: Dict[int, np.ndarray], keep) -> dict:
    """Readings over the sampled images: the worst and the median relative
    L2 distance from the reference, and the worst largest gap over the
    reference's largest value.  An image the window never wrote is
    infinitely far."""
    l2, mx = [], []
    for k in keep:
        if k not in produced:
            l2.append(float("inf"))
            mx.append(float("inf"))
            continue
        r = ref[k].astype(np.float64)
        d = produced[k].astype(np.float64) - r
        l2.append(float(np.linalg.norm(d) / np.linalg.norm(r)))
        mx.append(float(np.abs(d).max() / np.abs(r).max()))
    return {"emb_rel_l2": max(l2), "emb_rel_l2_median": float(np.median(l2)),
            "emb_max_rel": max(mx)}


def check(state: State, ctx) -> List[Check]:
    state.readings = compare(state.store.kept, reference_embeddings(ctx, state), state.keep)
    return judge(state.readings, ctx.traffic["limits"])


def control(state: State, ctx) -> dict:
    """The lower-precision control of the int8 cell: the plain ViT with its
    matrices and their inputs in int4 in the program's place, judged as the
    program is.  (The bf16 cell's control is the program's own int8 path:
    the int8 cell's mix.)"""
    if ctx.traffic["quantize"] != "int8":
        raise ValueError("the control of the bf16 mix is the program's int8 path")
    ref = reference_embeddings(ctx, state)
    return compare(reference_embeddings(ctx, state, bits=4), ref, state.keep)
