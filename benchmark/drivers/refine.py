"""The SAM refine sweep: the program's ``cli/save_refined_segmentations.py:
refine_images`` (U-Net probabilities, ``SegEnhance.enhance_batch`` with the
paper's refinement settings, the masks bit-packed on the device and
fetched one batch late) over a pool of X-ray-like images cycled, each with
an image embedding made from the seed and handed in through an in-memory
embeddings store, as the sweep's h5 file would; the encoder is bypassed.

The window is bracketed on whole batches (``harness/core.py:BatchStore``).
Correctness, on a sample of the window's batches drawn from the seed, in
two stages (the refinement is discrete: a U-Net probability that moves
across 0.5 changes a component and every prompt after it, so the enhance
stage is judged from the probabilities the program handed it):

* ``unet_prob_gap``: the largest gap between the program's probabilities
  and the plain float32 U-Net's on the same images;
* ``mask_mismatch``: the largest share of a refined mask's pixels that
  differ from the plain refinement (``reference/refine.py``) of the
  program's probabilities, and ``dice_gap``: the largest gap between the
  estimated Dice values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import faults, synth
from harness.core import BatchStore, Check, Names, StopWindow, Window, judge
from harness.models import (full_fp32, port_sam_config, port_unet_config, reference_sam,
                            reference_unet, seeded, tiny_sam)
from reference import refine as ref_refine
from reference import sam as ref_sam
from reference import unet as ref_unet


class Enhance:
    """The program's ``SegEnhance`` behind a span, keeping the sampled
    batches' input probabilities (the program's, untouched)."""

    def __init__(self, inner, spans):
        self.inner, self.spans = inner, spans
        self.calls = 0
        self.keep = set()
        self.kept: Dict[int, torch.Tensor] = {}

    def enhance_batch(self, segs, names):
        if self.calls in self.keep:
            self.kept[self.calls] = segs
        self.calls += 1
        with self.spans("enhance.enhance_batch"):
            return self.inner.enhance_batch(segs, names)


class UNetCall:
    """The program's U-Net behind a span."""

    def __init__(self, unet, spans):
        self.unet, self.spans = unet, spans

    @property
    def device(self):
        return self.unet.device

    def __call__(self, x):
        with self.spans("models.unet"):
            return self.unet(x)


@dataclass
class State:
    unet: object
    enhance: Enhance
    images: List[np.ndarray]
    features: np.ndarray
    sizes: tuple
    batch: int
    store: Optional[BatchStore] = None
    keep: List[int] = field(default_factory=list)
    launches: Dict[str, int] = field(default_factory=dict)
    readings: Dict[str, float] = field(default_factory=dict)


def _run(state: State, ctx, store, n_images: int = 10 ** 7) -> None:
    from samcarriestheburden_torch.cli.save_refined_segmentations import refine_images

    pool = state.images
    stems = Names(lambda k: f"p{k % len(pool)}", n_images)
    try:
        with ctx.spans("loops.refine_images"):
            refine_images(state.unet, state.enhance, stems, lambda s: pool[int(s[1:])], store,
                          img_batch=state.batch)
    except StopWindow:
        pass
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()


def setup(ctx) -> State:
    from samcarriestheburden_torch.data.h5io import MemoryEmbeddings
    from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead
    from samcarriestheburden_torch.engine.refinement import SamSegRefiner, SegEnhance
    from samcarriestheburden_torch.models.unet import build_unet

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    _, sam_sd = seeded(lambda: ref_sam.Sam(c, encoder=False), ctx.subseed("sam"), dev)
    _, unet_sd = seeded(lambda: ref_unet.UNet(c["unet"]), ctx.subseed("unet"), dev)
    head = SamMaskDecoderHead(None, "vit_h", MemoryEmbeddings(c["image_size"]), dev,
                              params=sam_sd,
                              cfg=port_sam_config(c),
                              compute_dtype=getattr(torch, t["decoder_dtype"]))
    r = c["refine"]
    refiner = SamSegRefiner(head, prompts2use=[r["prompts_first"], r["prompts_second"]])
    enh = Enhance(SegEnhance(refiner, r["ccl_selection"], r["morph_op"], r["struct_element"],
                             r["radius"]), ctx.spans)
    unet = build_unet(port_unet_config(c["unet"]), device=dev,
                      state_dict=unet_sd)
    grid = tuple(c["unet"]["grid_hw"])
    images = list(synth.xrays(ctx.subseed("images"), t["pool"], grid, dev).cpu().numpy())
    g = c["image_size"] // c["vit_patch_size"]
    gen = torch.Generator(device=dev).manual_seed(ctx.subseed("embeddings"))
    feats = torch.randn((t["pool"], 1, c["prompt_embed_dim"], g, g), generator=gen,
                        device=dev).cpu().numpy()
    orig = tuple(t["original_hw"])
    scale = c["image_size"] / max(orig)
    inp = (int(orig[0] * scale + 0.5), int(orig[1] * scale + 0.5))
    sizes = (np.asarray(orig), np.asarray(inp))
    store = head.reader
    for j in range(t["pool"]):
        store.write(f"p{j}", feats[j], orig, inp)
    state = State(UNetCall(unet, ctx.spans), enh, images, feats, sizes, t["batch_size"])
    rng = np.random.default_rng(ctx.subseed("sample"))
    state.keep = sorted(rng.choice(np.arange(1, 1 + t["check_within_batches"]),
                                   t["check_batches"], replace=False).tolist())
    _run(state, ctx, BatchStore(state.batch, float("inf"), -1, ctx.spans),
         state.batch * t["warmup_batches"])
    return state


def window(state: State, ctx, seconds: float) -> Window:
    from samcarriestheburden_torch.kernels import LAUNCHES

    b = state.batch
    before = dict(LAUNCHES)
    state.enhance.calls, state.enhance.keep = 0, set(state.keep)
    keep = set(state.keep)

    def take(n, stem, masks, estimated_dice=None):
        return (n, (np.array(masks, bool), np.array(estimated_dice))) if n // b in keep else None

    state.store = store = BatchStore(b, seconds, (max(keep) + 1) * b - 1, ctx.spans, take)
    _run(state, ctx, store)
    state.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    return store.window(enhance_calls=state.enhance.calls)


def release(state: State) -> None:
    state.unet = None
    state.enhance.inner = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@dataclass
class Produced:
    """What the window produced for the sampled batches: the probabilities
    handed to the enhance stage per batch, the written masks and Dice per
    image index."""
    probs: Dict[int, torch.Tensor]
    masks: Dict[int, tuple]


def reference_models(ctx):
    """The plain decoding half of SAM and the plain U-Net, with the run's
    weights."""
    c, dev = ctx.config, ctx.device
    return (reference_sam(c, ctx.subseed("sam"), dev, encoder=False),
            reference_unet(c["unet"], ctx.subseed("unet"), dev))


def _batch_images(state: State, batch: int) -> torch.Tensor:
    pool = state.images
    return torch.from_numpy(np.stack([pool[k % len(pool)] for k in
                                      range(batch * state.batch, (batch + 1) * state.batch)]))


@torch.no_grad()
def compare(ctx, state: State, produced: Produced) -> dict:
    """The readings over the sampled batches (module docstring); a batch or
    an image the window never produced is infinitely far."""
    c = ctx.config
    sam, unet = reference_models(ctx)
    prob_gap, mismatch, dice_gap = 0.0, 0.0, 0.0
    orig, inp = (tuple(int(v) for v in s) for s in state.sizes)
    with full_fp32():
        for bi in state.keep:
            if bi not in produced.probs:
                return {}
            imgs = _batch_images(state, bi).to(ctx.device)
            p_ref = ref_unet.probabilities(unet, imgs, c["unet"]["img_mean"], c["unet"]["img_std"])
            p_prog = produced.probs[bi].float()
            prob_gap = max(prob_gap, float((p_prog - p_ref).abs().max()))
            for j in range(state.batch):
                k = bi * state.batch + j
                if k not in produced.masks:
                    mismatch = dice_gap = float("inf")
                    continue
                feats = torch.from_numpy(state.features[k % len(state.features)]).to(ctx.device)
                refined, dice = ref_refine.refine_image(sam, p_prog[j].cpu().numpy(), feats,
                                                        inp, orig)
                m_prog, d_prog = produced.masks[k]
                mismatch = max(mismatch, float((m_prog != refined).mean(axis=(1, 2)).max()))
                both = np.isnan(d_prog) & np.isnan(dice)
                gap = np.where(both, 0.0, np.abs(d_prog.astype(np.float64) - dice))
                dice_gap = max(dice_gap, float(np.nan_to_num(gap, nan=np.inf).max()))
    return {"unet_prob_gap": prob_gap, "mask_mismatch": mismatch, "dice_gap": dice_gap}


def check(state: State, ctx) -> List[Check]:
    state.readings = compare(ctx, state, Produced(state.enhance.kept, state.store.kept))
    return judge(state.readings, ctx.traffic["limits"])


class BF16UNet:
    """The plain U-Net in bfloat16 in the program's U-Net's place."""

    def __init__(self, unet, device):
        self.unet, self.device = unet.to(torch.bfloat16), device

    def __call__(self, x):
        return self.unet(x.to(torch.bfloat16)).float()


def control(state: State, ctx) -> dict:
    """The lower-precision control, run as a window and judged as the
    program is: the plain U-Net in bfloat16 in the place of the program's
    (whose TF32 convolutions are float32 of the other kind), and the
    program's own bfloat16 decoder path (``decoder_dtype``; its float32
    decoder already runs its convolutions in TF32)."""
    if ctx.traffic["decoder_dtype"] != "bfloat16":
        raise ValueError("the control runs the program's bfloat16 decoder: set decoder_dtype")
    state.unet = BF16UNet(reference_models(ctx)[1], ctx.device)
    window(state, ctx, 2.0)
    return compare(ctx, state, Produced(state.enhance.kept, state.store.kept))


#: the lower-precision control: :func:`control` in the program's place,
#: with the program's own bfloat16 decoder
CONTROL = ("control", {"decoder_dtype": "bfloat16"})
#: the faults this cell can have (``harness/faults.py``)
FAULTS = {"half_batch": faults.refine_half_batch, "answer_altered": faults.refine_answer_altered}


def tiny(config: dict, traffic: dict) -> None:
    """The cell at a CPU test's size: toy SAM widths, 96 × 64 originals,
    two batches checked."""
    tiny_sam(config, traffic)
    traffic.update(original_hw=[96, 64], check_batches=2)
