"""Roofline of the refinement decode: the 17-class two-round decode's FLOPs
and bytes against its measured time (JAX ``tools/exp_refine_roofline.py``).

    python -m samcarriestheburden_torch.tools.refine_roofline [--dtype fp32 bf16]
        [--iters 20]

The decode is ``models/sam.py:two_round_decode``'s: one image's (1, 256,
64, 64) embedding, 17 prompt sets of 18 points (one positive, 16
negatives, one pad: the JAX tool's), round 1 sharing the image side, round 2
feeding round 1's logits back as the mask prompt; the mask decoder in fp32
or bf16 (``predict_masks(dtype=)``, the serving setting), ViT-H SAM with
seeded random weights.

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one call (the
  products: ``mm``, ``addmm``, ``bmm``, convolutions), held equal to
  :func:`analytic_flops`, the products counted from the shapes.  Where the
  fp32 decode on the card runs its blocks' image-to-token branch as D1
  (``kernels/decoder.py``), the counter takes D1's products from its
  operator's flop formula, and the analytic count adds the (HW, 128)
  positional table that D1's split of q projects once a block.
* Bytes: counted by hand (:func:`hand_bytes`), the dominant tensors round
  by round, each written once and read once, as the JAX tool prints them:
  the keys of every attention pass, the two transposed convolutions'
  outputs, the masks; the port has no XLA "bytes accessed".
* Time: CUDA events over ``--iters`` calls after two warm-up calls.

It prints the achieved FLOP rate against 989 TFLOP/s (the H100's dense bf16
peak) and the achieved bandwidth against 3.35 TB/s, the arithmetic
intensity against the ridge point, and the bandwidth floor.  Runs on the
card; ``device="cpu"`` counts on the CPU (no device rate).
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Dict, Optional, Sequence

import torch

from samcarriestheburden_torch.config import N_CLASSES, sam_vit_h_config
from samcarriestheburden_torch.device import resolve_device

PEAK_FLOPS = 989e12          # H100 SXM dense bf16 (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
N_POINTS = 1 + (N_CLASSES - 1) + 1


def decode_inputs(model, device, b: int = N_CLASSES, n_points: int = N_POINTS, seed: int = 0):
    """(features (1, C, H, W), coords (b, n, 2), labels (b, n)): the JAX
    tool's prompt sets, one positive, n - 2 negatives and a pad each."""
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    features = torch.randn((1, cfg.mask_decoder.transformer_dim,
                            *cfg.prompt_encoder.image_embedding_size),
                           generator=gen, device=device)
    coords = torch.rand((b, n_points, 2), generator=gen, device=device) * model.img_size
    labels = torch.cat([torch.ones(b, 1), torch.zeros(b, n_points - 2), -torch.ones(b, 1)],
                       1).to(device, torch.int64)
    return features, coords, labels


def decode(model, features, coords, labels, dtype=torch.float32):
    """``two_round_decode`` with the mask decoder in ``dtype``."""
    pe = model.prompt_encoder
    md = model.mask_decoder
    sparse = pe.embed_unified_points(coords, labels)
    image_pe = pe.get_dense_pe()
    low1, _ = md(features, image_pe, sparse, pe.no_mask_dense(1), False, image_shared=True,
                 dtype=dtype)
    return md(features, image_pe, sparse, pe.embed_masks(low1), False, dtype=dtype)


def _attention(b_q: int, n_q: int, b_kv: int, n_kv: int, c: int, d: int, *,
               q_rows: Optional[int] = None) -> int:
    """One ``Attention``'s products: q over ``q_rows`` (default b_q * n_q)
    rows, k and v over b_kv * n_kv, q.k and p.v over b_q * n_q x n_kv (the
    keys of the query's own item), the output over b_q * n_q rows."""
    q_rows = b_q * n_q if q_rows is None else q_rows
    return 2 * (q_rows * c * d + 2 * b_kv * n_kv * c * d + 2 * b_q * n_q * n_kv * d
                + b_q * n_q * d * c)


def analytic_flops(cfg, b: int, n_points: int, n_img: int = 1,
                   fused: bool = False) -> Dict[str, int]:
    """The products of one two-round decode of ``b`` prompt sets of
    ``n_points`` points over ``n_img`` images, counted from the shapes:
    {"prompt", "round1", "round2"} (multiply-adds x 2).  ``fused``: the
    blocks' image-to-token branch runs as D1, which also projects the
    positional term of q once a block, an (HW, C) x (C, C / 2) product."""
    md, pc = cfg.mask_decoder, cfg.prompt_encoder
    c, m, nt = md.transformer_dim, md.transformer_mlp_dim, md.num_mask_tokens
    ci = c // md.attention_downsample_rate
    h, w = pc.image_embedding_size
    hw = h * w
    n = 1 + nt + n_points
    mc = pc.mask_in_chans
    prompt = 2 * b * n_points * 2 * (c // 2) + 2 * hw * 2 * (c // 2)   # point and grid PE

    def block(shared: bool) -> int:
        f = _attention(b, n, b, n, c, c) + 2 * b * n * c * m * 2      # self-attn, MLP
        if shared:   # the image side projected once per image (round 1's layer 0)
            f += _attention(b, n, n_img, hw, c, ci)                   # token to image
            f += _attention(b, hw, b, n, c, ci, q_rows=n_img * hw)    # image to token
        else:
            f += _attention(b, n, b, hw, c, ci) + _attention(b, hw, b, n, c, ci)
        return f + (2 * hw * c * ci if fused else 0)

    def head() -> int:
        up = 2 * b * c * (c // 4) * 4 * hw + 2 * b * (c // 4) * (c // 8) * 4 * 4 * hw
        hyper = nt * 2 * b * (c * c + c * c + c * (c // 8))
        masks = 2 * b * nt * (c // 8) * 16 * hw
        dims = [c] + [md.iou_head_hidden_dim] * (md.iou_head_depth - 1) + [nt]
        iou = sum(2 * b * i * o for i, o in zip(dims, dims[1:]))
        return up + hyper + masks + iou

    def rnd(shared: bool) -> int:
        layers = [block(shared and i == 0) for i in range(md.transformer_depth)]
        return sum(layers) + _attention(b, n, b, hw, c, ci) + head()

    downscale = (2 * b * (mc // 4) * 4 * 4 * hw + 2 * b * mc * (mc // 4) * 4 * hw
                 + 2 * b * c * mc * hw)
    return {"prompt": prompt, "round1": rnd(True), "round2": downscale + rnd(False)}


def dominant_tensors(cfg, b: int, dtype=torch.float32) -> Dict[str, Dict[str, tuple]]:
    """The dominant tensors of each round: {round: {tensor: (shape, dtype,
    accesses)}}, each written once and read once by every pass that takes
    it.  ``dtype``: the mask decoder's compute type; the prompt encoder's
    dense embedding, the round-1 logits and the masks are fp32 either way."""
    md, pc = cfg.mask_decoder, cfg.prompt_encoder
    c, nt = md.transformer_dim, md.num_mask_tokens
    h, w = pc.image_embedding_size
    passes = 2 * md.transformer_depth + 1            # t2i and i2t a layer, the final t2i
    rnd = {"keys": ((b, h * w, c), dtype, 2 * passes),
           "upscale1": ((b, c // 4, 2 * h, 2 * w), dtype, 2),
           "upscale2": ((b, c // 8, 4 * h, 4 * w), dtype, 2),
           "masks": ((b, nt, 4 * h, 4 * w), torch.float32, 2)}
    return {"round1": dict(rnd),
            "round2": {**rnd, "mask_prompt": ((b, 1, 4 * h, 4 * w), torch.float32, 1),
                       "dense": ((b, c, h, w), torch.float32, 2)}}


def hand_bytes(cfg, b: int, dtype=torch.float32) -> Dict[str, Dict[str, int]]:
    """:func:`dominant_tensors` in bytes: {round: {tensor: bytes}}."""
    def nbytes(shape, dt, accesses):
        n = 1
        for d in shape:
            n *= d
        return n * (torch.finfo(dt).bits // 8) * accesses
    return {r: {k: nbytes(*v) for k, v in ts.items()}
            for r, ts in dominant_tensors(cfg, b, dtype).items()}


@contextlib.contextmanager
def _frozen(model):
    """``model``'s parameters without ``requires_grad`` (FlopCounterMode's
    module tracker refuses views of trainable leaves made under no_grad)."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    model.requires_grad_(False)
    try:
        yield model
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def count_flops(model, inputs, dtype=torch.float32) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with _frozen(model), torch.no_grad(), FlopCounterMode(display=False) as fc:
        decode(model, *inputs, dtype=dtype)
    return fc.get_total_flops()


def refine_roofline(device=None, *, model=None, dtypes: Sequence[str] = ("fp32", "bf16"),
                    iters: int = 20) -> Dict[str, dict]:
    """{dtype: {"ms", "flops", "analytic_flops", "bytes", "tflops", "tbps",
    "flop_share", "byte_share", "intensity", "floor_ms"}}, printed.
    ``model``: a ``SamModel`` on ``device`` (default: ViT-H, seed 0)."""
    from samcarriestheburden_torch.kernels import decoder

    dev = resolve_device(device)
    if model is None:
        from samcarriestheburden_torch.models.sam import build_sam

        model = build_sam(sam_vit_h_config(), device=dev, seed=0)
    inputs = decode_inputs(model, dev)
    b, n = inputs[2].shape
    out = {}
    for name in dtypes:
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        flops = count_flops(model, inputs, dtype)
        fused = decoder.fused_applies(dev.type, dtype)
        analytic = sum(analytic_flops(model.cfg, b, n, fused=fused).values())
        nbytes = sum(sum(r.values()) for r in hand_bytes(model.cfg, b, dtype).values())
        res = {"flops": flops, "analytic_flops": analytic, "bytes": nbytes,
               "intensity": flops / nbytes, "ridge": PEAK_FLOPS / PEAK_BYTES,
               "floor_ms": max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3}
        if dev.type == "cuda":
            from samcarriestheburden_torch.tools.timing import device_us

            with torch.no_grad():
                res["ms"] = device_us(lambda: decode(model, *inputs, dtype=dtype), (),
                                      iters=iters) / 1e3
            res["tflops"] = flops / res["ms"] / 1e9
            res["tbps"] = nbytes / res["ms"] / 1e9
            res["flop_share"] = res["tflops"] * 1e12 / PEAK_FLOPS
            res["byte_share"] = res["tbps"] * 1e12 / PEAK_BYTES
        out[name] = res
        print(f"refine {b}-class 2-round ({name} decoder): {flops / 1e9:.4f} GFLOP "
              f"(analytic {analytic / 1e9:.4f}), hand-counted {nbytes / 1e6:.2f} MB, intensity "
              f"{res['intensity']:.1f} FLOP/B (ridge {res['ridge']:.0f}), floor "
              f"{res['floor_ms']:.4f} ms", flush=True)
        if "ms" in res:
            print(f"  t = {res['ms']:.4f} ms -> {res['tflops']:.3f} TFLOP/s "
                  f"({100 * res['flop_share']:.2f} % of 989), {res['tbps'] * 1e3:.1f} GB/s "
                  f"({100 * res['byte_share']:.2f} % of 3.35 TB/s); {res['ms'] / res['floor_ms']:.1f}x "
                  f"the floor", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", nargs="+", choices=["fp32", "bf16"], default=["fp32", "bf16"])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    refine_roofline(dtypes=args.dtype, iters=args.iters)


if __name__ == "__main__":
    main()
