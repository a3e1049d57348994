"""The yardstick's arithmetic: the card's peaks, the analytic work of each
layer counted from its shapes, and each kernel's least time.

Products are counted as 2 operations per multiply-add; normalisations,
softmax, activations and pooling are not counted.  Every count is of work
that the result needs, so that no implementation can do it in less time
than the peaks allow:

* the ViT encoder (after the program's bench ``analytic_encoder_flops``):
  the projections and MLP on the image's real tokens only, attention
  within each window over the window's real tokens, the decomposed
  relative-position terms, the patch embedding and the neck;
* the U-Net (after ``analytic_unet_flops``): every convolution and
  transposed convolution; the backward pass twice the forward, except the
  first convolution's input gradient;
* the refinement decode (after ``tools/refine_roofline.py:
  analytic_flops``): the prompt encodings and both rounds, round 1 with each
  image's side projected once, each round at its own point count.

The least time of a count is the sum of its terms, each at the dense peak
of its operand type: 1,979 TOP/s for int8 operands, 989 TFLOP/s for every
floating-point term whatever precision it runs in now, so that no later
change of precision can read above 100 % (NVIDIA H100 SXM data sheet).
"""

from __future__ import annotations

from typing import Dict

PEAK_INT8 = 1979e12
PEAK_FLOAT = 989e12
PEAK_BYTES = 3.35e12


def least_seconds(work: Dict[str, float]) -> float:
    """{'int8': ops, 'float': flops} -> seconds at the dense peaks."""
    return work.get("int8", 0.0) / PEAK_INT8 + work.get("float", 0.0) / PEAK_FLOAT


# ---------------------------------------------------------------------------
# ViT encoder
# ---------------------------------------------------------------------------


def window_shapes(grid: int, ws: int):
    """[(rows, cols, count)] of the windows that tile a grid x grid token
    map, edge windows cut to the tokens that exist."""
    full, rest = divmod(grid, ws)
    sides = [(ws, full)] + ([(rest, 1)] if rest else [])
    return [(rh, rw, nh * nw) for rh, nh in sides for rw, nw in sides]


def encoder_work(c: dict, int8: bool) -> Dict[str, float]:
    """One image through the encoder: {'int8', 'float'} operations.  With
    ``int8`` the qkv, lin1 and lin2 products and the global blocks' q.k run
    on int8 operands (the int8 serving mode)."""
    d = c["encoder_embed_dim"]
    g = c["image_size"] // c["vit_patch_size"]
    t = g * g
    hidden = int(d * c["mlp_ratio"])
    n_glob = len(c["encoder_global_attn_indexes"])
    n_win = c["encoder_depth"] - n_glob
    qkv, proj, mlp = 2 * t * d * 3 * d, 2 * t * d * d, 2 * 2 * t * d * hidden
    win = sum(k * (2 * 2 * (rh * rw) ** 2 * d + 2 * rh * rw * (rh + rw) * d)
              for rh, rw, k in window_shapes(g, c["window_size"]))
    qk_glob = 2 * t * t * d
    pv_glob = 2 * t * t * d
    rel_glob = 2 * t * (g + g) * d
    neck = 2 * t * d * c["prompt_embed_dim"] + 2 * t * 9 * c["prompt_embed_dim"] ** 2
    patch = 2 * t * 3 * c["vit_patch_size"] ** 2 * d
    lowp = c["encoder_depth"] * (qkv + mlp) + (n_glob * qk_glob if int8 else 0)
    flt = (c["encoder_depth"] * proj + win * n_win
           + n_glob * (pv_glob + rel_glob + (0 if int8 else qk_glob)) + neck + patch)
    if int8:
        return {"int8": float(lowp), "float": float(flt)}
    return {"int8": 0.0, "float": float(lowp + flt)}


def compact_rows(grid: int, ws: int) -> int:
    """Token rows per image of the program's compact window layout
    (``models/image_encoder.py:compact_window_groups``): each window's
    rows rounded up to 8, the bottom strip's windows spanning the full
    width.  The call shape of the windowed blocks' kernels."""
    full, rest = divmod(grid, ws)
    r8 = lambda n: -(-n // 8) * 8  # noqa: E731
    rows = full * full * r8(ws * ws)
    if rest:
        rows += full * r8(ws * rest) + (-(-grid // ws)) * r8(rest * ws)
    return rows


def mlp_kernel_bound(rows: int, d: int, hidden: int, int8: bool, add: bool) -> float:
    """Least seconds of one fused LN + MLP + residual launch (K3, K4) on
    ``rows`` rows: both products at the peak of their operands, or the
    bytes (bf16 rows in, the added rows, bf16 rows out, the weights once)."""
    ops = 2 * 2 * rows * d * hidden
    wbytes = 2 * d * hidden * (1 if int8 else 2)
    nbytes = rows * d * 2 * (3 if add else 2) + wbytes
    return max(ops / (PEAK_INT8 if int8 else PEAK_FLOAT), nbytes / PEAK_BYTES)


def encoder_mlp_bounds(c: dict, batch: int, int8: bool) -> float:
    """Least seconds of one batch's MLP launches: the windowed blocks on
    the compact rows with the attention output added, the global blocks on
    the grid's rows."""
    d = c["encoder_embed_dim"]
    hidden = int(d * c["mlp_ratio"])
    g = c["image_size"] // c["vit_patch_size"]
    n_glob = len(c["encoder_global_attn_indexes"])
    win = mlp_kernel_bound(batch * compact_rows(g, c["window_size"]), d, hidden, int8, True)
    glob = mlp_kernel_bound(batch * g * g, d, hidden, int8, False)
    return (c["encoder_depth"] - n_glob) * win + n_glob * glob


# ---------------------------------------------------------------------------
# U-Net
# ---------------------------------------------------------------------------


def unet_work(u: dict, hw) -> Dict[str, float]:
    """One image of ``hw`` through the U-Net: {'forward', 'train'} FLOPs."""
    bc = u["base_channels"]
    h, w = hw
    sizes = [(h, w)]
    for _ in range(4):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))

    def conv(s, cin, cout, k):
        return 2.0 * s[0] * s[1] * cin * cout * k * k

    chans = [bc, bc * 2, bc * 4, bc * 8, bc * 16]
    first = conv(sizes[0], u["n_channels"], bc, 3)
    fwd = first + conv(sizes[0], bc, bc, 3)
    for i in range(1, 5):
        fwd += conv(sizes[i], chans[i - 1], chans[i], 3) + conv(sizes[i], chans[i], chans[i], 3)
    outs = [chans[3], chans[2], chans[1], u["n_last_channel"]]
    for i, cout in zip(range(4, 0, -1), outs):
        cin = chans[i]
        fwd += conv(sizes[i - 1], cin, cin // 2, 1)       # 2x2, stride 2: one tap an output
        fwd += conv(sizes[i - 1], cin, cout, 3) + conv(sizes[i - 1], cout, cout, 3)
    fwd += conv(sizes[0], u["n_last_channel"], u["n_classes"], 1)
    return {"forward": fwd, "train": 3 * fwd - first}


# ---------------------------------------------------------------------------
# the refinement decode
# ---------------------------------------------------------------------------


def _attention(b_q, n_q, b_kv, n_kv, c, d, q_rows=None):
    q_rows = b_q * n_q if q_rows is None else q_rows
    return 2 * (q_rows * c * d + 2 * b_kv * n_kv * c * d + 2 * b_q * n_q * n_kv * d
                + b_q * n_q * d * c)


def decode_work(c: dict, b: int, n_img: int, points1: int, points2: int) -> float:
    """FLOPs of one two-round refinement decode of ``b`` prompt sets over
    ``n_img`` images, ``points1`` points in round 1 and ``points2`` in
    round 2."""
    d, m = c["prompt_embed_dim"], c["transformer_mlp_dim"]
    nt = c["num_multimask_outputs"] + 1
    ci = d // 2
    g = c["image_size"] // c["vit_patch_size"]
    hw = g * g
    mc = c["mask_in_chans"]

    def block(n, shared):
        f = _attention(b, n, b, n, d, d) + 2 * b * n * d * m * 2
        if shared:
            f += _attention(b, n, n_img, hw, d, ci) + _attention(b, hw, b, n, d, ci,
                                                                q_rows=n_img * hw)
        else:
            f += _attention(b, n, b, hw, d, ci) + _attention(b, hw, b, n, d, ci)
        return f

    def head():
        up = 2 * b * d * (d // 4) * 4 * hw + 2 * b * (d // 4) * (d // 8) * 4 * 4 * hw
        hyper = nt * 2 * b * (d * d + d * d + d * (d // 8))
        masks = 2 * b * nt * (d // 8) * 16 * hw
        dims = [d] + [c["iou_head_hidden_dim"]] * (c["iou_head_depth"] - 1) + [nt]
        return up + hyper + masks + sum(2 * b * i * o for i, o in zip(dims, dims[1:]))

    def rnd(points, shared):
        n = 1 + nt + points
        layers = sum(block(n, shared and i == 0) for i in range(c["transformer_depth"]))
        return layers + _attention(b, n, b, hw, d, ci) + head()

    prompt = 2 * b * (points1 + points2) * 2 * (d // 2) + 2 * hw * 2 * (d // 2)
    downscale = (2 * b * (mc // 4) * 4 * 4 * hw + 2 * b * mc * (mc // 4) * 4 * hw
                 + 2 * b * d * mc * hw)
    return float(prompt + rnd(points1, True) + downscale + rnd(points2, False))
