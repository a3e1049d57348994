"""The serving encoder's layouts and block formulations, timed in turns on
one card, and its parts on flat against compact rows (JAX
``tools/bench_encoder_ab.py``, ``tools/exp_v4.py`` and
``tools/exp_compact_parts.py``).

    python -m samcarriestheburden_torch.tools.encoder_ab [--batch 32]
        [--compact on off] [--quantize int8 none] [--formulation flat v1 v2 v3]
        [--iters 3] [--parts]

A/B: ViT-H SAM with seeded random weights (seed 0) encodes ``--batch``
seeded uint8 images of input size 1024 x 716 (the bench's) in every valid
combination of the flags, in turns: the combinations in order, then in
reverse.  ``flat`` is the serving formulation (JAX's "v4",
``samcarriestheburden_tpu/models/image_encoder.py:784``; K1, K3, K5, K7 or
int8 K2, K4, K5, K7-int8) through ``make_serving_encoder``, in the compact
layout (``on``: K6 for the edge windows) or the flat one; ``v1`` is the
unfused attention (K9, ``attention_apply_kernel``), ``v2`` the fused window
block (K12), ``v3`` the head-major blocks (K10 windows, K11 globals),
composed here block by block as ``chip_smoke.py`` runs them.  The int8 mode
and the compact layout exist on ``flat`` alone.  Each turn times
``--iters`` calls by CUDA events after one warm-up call and prints ms per
batch and images/s; each combination's first embedding is held against the
flat bf16 (or int8) one: the max and mean |difference|.

``--parts`` (``exp_compact_parts.py``): one block's pieces at ViT-H's batch
shapes, flat against compact: K3 and K4 (the MLP) and K1 and K2 (LN + qkv)
on 5000 against 4208 rows an image; K5 on the 25 flat windows against K5 on
the 16 interior windows plus K6 on each edge group; partition and
unpartition of both layouts.  Runs on the card; ``device="cpu"`` runs the
plain versions.
"""

from __future__ import annotations

import argparse
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from samcarriestheburden_torch.config import sam_vit_h_config
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.tools.timing import call_ms

INPUT_HW = (1024, 716)
FORMULATIONS = ("flat", "v1", "v2", "v3")


def combos(formulations: Sequence[str], compact: Sequence[str], quantize: Sequence[str]
           ) -> List[Tuple[str, str, str]]:
    """The valid (formulation, compact, quantize) triples, in flag order:
    int8 and the compact layout on ``flat`` alone."""
    out = []
    for f, c, q in itertools.product(formulations, compact, quantize):
        if f == "flat" or (c == "off" and q == "none"):
            out.append((f, c, q))
    return list(dict.fromkeys(out))


def images(batch: int, size: int, device, input_hw=INPUT_HW, seed: int = 1):
    """(B, 3, size, size) seeded uint8 images, zero beyond ``input_hw``, and
    their (B, 2) sizes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    imgs = torch.randint(0, 256, (batch, 3, size, size), generator=gen, device=device,
                         dtype=torch.uint8)
    imgs[:, :, input_hw[0]:] = 0
    imgs[:, :, :, input_hw[1]:] = 0
    sizes = torch.tensor([input_hw] * batch, dtype=torch.int32, device=device)
    return imgs, sizes


def v3_encoder(model, dtype):
    """``encode(packed, imgs, sizes)`` in the head-major formulation: the
    windowed blocks through ``block_apply_windowed(fused_qkv=True)`` (K1,
    K10, K3) in the window layout, each global block through
    ``global_attention_rel_outside`` (K1, K11) and K3; the serving
    preprocessing, patch embedding and neck."""
    from samcarriestheburden_torch.models import image_encoder as tie

    enc = model.image_encoder
    cfg = enc.cfg
    size = model.img_size

    @torch.no_grad()
    def encode(packed, imgs, sizes):
        ih = torch.arange(size, device=imgs.device)
        valid = ((ih[None, :, None] < sizes[:, 0, None, None])
                 & (ih[None, None, :] < sizes[:, 1, None, None]))
        x = (imgs.float() - model.pixel_mean) / model.pixel_std * valid[:, None]
        x = enc.embed_patches(x, dtype)
        b, h, w, e = x.shape
        ws = cfg.window_size
        pad_valid = tie.pad_valid_mask(b, h, w, ws, dtype, x.device)
        run: List[int] = []
        for i in range(cfg.depth + 1):
            is_global = i < cfg.depth and i in cfg.global_attn_indexes
            if (i == cfg.depth or is_global) and run:
                xw, pad_hw = tie.window_partition(x, ws)
                for j in run:
                    xw = tie.block_apply_windowed(packed[j], xw, pad_valid, cfg, fused_mlp=True,
                                                  fused_qkv=True)
                x = tie.window_unpartition(xw, ws, pad_hw, (h, w))
                run = []
            if i == cfg.depth:
                break
            if is_global:
                a = tie.global_attention_rel_outside(packed[i], x, cfg)
                x = tie._mlp_residual(packed[i], x.reshape(a.shape), a, cfg,
                                      tie.KERNEL_OPS).reshape(x.shape)
            else:
                run.append(i)
        return enc.neck(x.float().permute(0, 3, 1, 2))

    return encode


def make_encoder(model, formulation: str, compact: str, quantize: str, dtype):
    """(encode, packed) of one combination."""
    from samcarriestheburden_torch.engine.embeddings import make_serving_encoder
    from samcarriestheburden_torch.models import image_encoder as tie

    q = None if quantize == "none" else quantize
    if formulation == "flat":
        return make_serving_encoder(model, dtype, quantize=q, compact_windows=compact == "on")
    if formulation == "v3":
        return v3_encoder(model, dtype), model.image_encoder.pack(dtype)
    variant = dict(v1=dict(attention_impl=tie.attention_apply_kernel, fused_qkv=False),
                   v2=dict(fused_window_blocks=True))[formulation]
    return make_serving_encoder(model, dtype, **variant)


def encoder_ab(device=None, *, model=None, batch: int = 32,
               formulations: Sequence[str] = ("flat",), compact: Sequence[str] = ("on", "off"),
               quantize: Sequence[str] = ("int8", "none"), iters: int = 3,
               dtype=None, input_hw=INPUT_HW) -> Dict[str, dict]:
    """{"formulation compact quantize": {"ms": [per turn], "images_per_s",
    "max_diff", "mean_diff", "embedding"}}: the turns, printed as they go;
    ``embedding`` is the first turn's output (the diffs are against the
    ``flat`` combination of the same ``quantize``, compact where it ran)."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if model is None:
        from samcarriestheburden_torch.models.sam import build_sam

        model = build_sam(sam_vit_h_config(), device=dev, seed=0)
    imgs, sizes = images(batch, model.img_size, dev, input_hw)
    todo = combos(formulations, compact, quantize)
    out: Dict[str, dict] = {}
    for turn, (f, c, q) in enumerate(todo + todo[::-1]):
        key = f"{f} {c} {q}"
        encode, packed = make_encoder(model, f, c, q, dtype)
        emb = encode(packed, imgs, sizes)
        ms = call_ms(lambda: encode(packed, imgs, sizes), iters, dev)
        rec = out.setdefault(key, {"ms": [], "embedding": emb})
        rec["ms"].append(ms)
        print(f"turn {turn}: {key}: {ms:.4f} ms per batch of {batch} "
              f"({batch / ms * 1e3:.3f} images/s)", flush=True)
        del encode, packed
    for key, rec in out.items():
        f, c, q = key.split()
        ref = next((out[k]["embedding"] for k in (f"flat on {q}", f"flat off {q}") if k in out),
                   rec["embedding"])
        diff = (rec["embedding"] - ref).abs()
        rec.update(images_per_s=batch / (sum(rec["ms"]) / len(rec["ms"])) * 1e3,
                   max_diff=diff.max().item(), mean_diff=diff.mean().item())
        print(f"{key}: ms {', '.join(f'{m:.4f}' for m in rec['ms'])}; "
              f"{rec['images_per_s']:.3f} images/s; against the flat {q} embedding max "
              f"{rec['max_diff']:.4g}, mean {rec['mean_diff']:.4g}", flush=True)
    return out


def parts(device=None, *, model=None, batch: int = 32, iters: int = 10, dtype=None
          ) -> Dict[str, float]:
    """{part: ms}: one block's pieces on the flat and on the compact layout
    at ``batch`` images (module docstring), printed."""
    from samcarriestheburden_torch.models import image_encoder as tie
    from samcarriestheburden_torch.models.quantize import prequantize_sam

    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if model is None:
        from samcarriestheburden_torch.models.sam import build_sam

        model = build_sam(sam_vit_h_config(), device=dev, seed=0)
    cfg = model.image_encoder.cfg
    g, ws, e = cfg.grid_size, cfg.window_size, cfg.embed_dim
    heads, hd = cfg.num_heads, cfg.head_dim
    pk = model.image_encoder.pack(dtype)[0]
    pk8 = prequantize_sam(model, dtype)[0]
    gen = torch.Generator(device=dev).manual_seed(2)
    groups = tie.compact_window_groups(g, g, ws)
    flat_rows = batch * (-(-g // ws)) ** 2 * (-(-ws * ws // 8) * 8)
    compact_rows = batch * sum(x["nh"] * x["nw"] * x["np"] for x in groups)
    res: Dict[str, float] = {}

    def timed(name, fn):
        res[name] = call_ms(fn, iters, dev)
        print(f"{name}: {res[name]:.4f} ms", flush=True)

    for rows, layout in ((flat_rows, "flat"), (compact_rows, "compact")):
        x = torch.randn((rows, e), generator=gen, device=dev).to(dtype)
        a = torch.randn((rows, e), generator=gen, device=dev).to(dtype)
        mask = torch.ones((rows, 1), device=dev, dtype=dtype)
        for name, p, ops in (("bf16", pk, tie.KERNEL_OPS), ("int8", pk8, tie.KERNEL_OPS_INT8)):
            timed(f"{name} ln+qkv {layout} {rows} rows",
                  lambda x=x, p=p, ops=ops: tie._ln_qkv(p, x, mask, cfg, ops))
            timed(f"{name} mlp {layout} {rows} rows",
                  lambda x=x, p=p, ops=ops: tie._mlp_residual(p, x, a, cfg, ops))
        del x, a, mask

    def qkv(wb, np_):
        return torch.randn((wb, np_, 3 * e), generator=gen, device=dev).to(dtype)

    n_flat = batch * (-(-g // ws)) ** 2
    q_flat = qkv(n_flat, -(-ws * ws // 8) * 8)
    timed(f"K5 flat {n_flat} windows", lambda: tie.KERNEL_OPS.rel_attention_window(
        q_flat, pk["tables"], ws=ws, heads=heads, hd=hd))
    del q_flat
    total = 0.0
    for grp in groups:
        wb = batch * grp["nh"] * grp["nw"]
        q = qkv(wb, grp["np"])
        if grp["rh"] == ws and grp["rw"] == ws:
            name = f"K5 compact interior {wb} windows"
            timed(name, lambda q=q: tie.KERNEL_OPS.rel_attention_window(
                q, pk["tables"], ws=ws, heads=heads, hd=hd))
        else:
            name = f"K6 compact {grp['rh']}x{grp['rw']} {wb} windows"
            timed(name, lambda q=q, grp=grp: tie.KERNEL_OPS.rel_attention_window_rect(
                q, pk["tables"], pk["qkv_b"], ws=ws, rh=grp["rh"], rw=grp["rw"], heads=heads,
                hd=hd))
        total += res[name]
    res["compact attention total"] = total
    print(f"compact attention total: {total:.4f} ms", flush=True)

    x = torch.randn((batch, g, g, e), generator=gen, device=dev).to(dtype)
    timed("partition flat", lambda: tie.window_partition_flat(x, ws))
    timed("partition compact", lambda: tie.window_partition_compact(x, groups))
    flat, pad_hw = tie.window_partition_flat(x, ws)
    timed("unpartition flat", lambda: tie.window_unpartition_flat(flat, ws, pad_hw, (g, g)))
    stream = tie.window_partition_compact(x, groups)
    timed("unpartition compact", lambda: tie.window_unpartition_compact(stream, groups, batch,
                                                                        (g, g)))
    return res


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, nargs="+", default=[32])
    p.add_argument("--compact", nargs="+", choices=["on", "off"], default=["on", "off"])
    p.add_argument("--quantize", nargs="+", choices=["int8", "none"], default=["int8", "none"])
    p.add_argument("--formulation", nargs="+", choices=FORMULATIONS, default=["flat"])
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--parts", action="store_true",
                   help="time one block's pieces on flat against compact rows instead")
    args = p.parse_args(argv)
    from samcarriestheburden_torch.models.sam import build_sam

    dev = resolve_device(None)
    model = build_sam(sam_vit_h_config(), device=dev, seed=0)
    for batch in args.batch:
        if args.parts:
            parts(model=model, batch=batch)
        else:
            encoder_ab(model=model, batch=batch, formulations=args.formulation,
                       compact=args.compact, quantize=args.quantize, iters=args.iters)


if __name__ == "__main__":
    main()
