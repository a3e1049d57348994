"""The softmax formulation's cost in the fused attention kernels: the port of
the JAX package's ``tools/exp_attn.py``.

    python -m samcarriestheburden_torch.tools.exp_attn [win glob]   (default: both)

Times K5's and K7's function at the script's shapes (16 heads, head dim 80;
200 windows of 14 x 14 tokens in 200 slots, 196 of them keys; 8 grids of
64 x 64 tokens) in the script's three softmax forms and prints each
experiment's device time per call (CUDA events over ``ITERS`` calls) and a
summary:

* ``v1``: fp32 exp, divide, then p . v: K16-v1;
* ``v2``: fp32 exp, p . v, then x 1/sum: K5 (windows) and K7 (grids), whose
  online softmax applies 1/sum after p . v;
* ``v3``: exp of the logits rounded to bf16, the probabilities rounded to
  bf16, then as v2: K16-v3.

``g_block`` and ``q_block`` are the TPU kernels' tiles; the port tiles in its
own way, so ``win_v3_g50``, ``win_v3_g100`` and ``glob_v3_q2048`` run the
same launch as ``win_v3`` and ``glob_v3``.  Inputs are the script's, from
``np.random.default_rng(0)`` in its draw order (windows, then grids, each
only if asked for), drawn straight into bf16: qkv head-major with each
head's 240 columns padded to 256, and the packed (80, 256) rel table.  They
are converted once, outside the timed calls, into the port's operands by
:func:`operands`.
"""

from __future__ import annotations

import sys
from functools import partial
from typing import Dict, Iterable

import numpy as np
import torch

from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.kernels.attention import rel_attention_forms
from samcarriestheburden_torch.tools.timing import print_summary, run_experiments

HEADS, HD = 16, 80
WS, NP, WB = 14, 200, 200        # 25 windows x batch 8, 196 tokens in 200 slots
GS, GB = 64, 8                   # the global layers' 64 x 64 grid at batch 8
PAD = 256                        # the script's columns per head: 3 * HD padded to 128 lanes
LANES = 128                      # tcat holds Rh in columns 0.. and Rw in 128..

#: name: (group, form): the script's experiments in its order
EXPERIMENTS = {
    "win_v1": ("win", dict(softmax="v1")),
    "win_v2": ("win", dict(softmax="v2")),
    "win_v3": ("win", dict(softmax="v3")),
    "win_v3_g50": ("win", dict(softmax="v3")),
    "win_v3_g100": ("win", dict(softmax="v3")),
    "glob_v1": ("glob", dict(softmax="v1")),
    "glob_v2": ("glob", dict(softmax="v2")),
    "glob_v3": ("glob", dict(softmax="v3")),
    "glob_v3_q2048": ("glob", dict(softmax="v3")),
}
NAMES = tuple(EXPERIMENTS)
GROUPS = ("win", "glob")         # the script's draw order
NOTES = {"win_v3_g50": "g_block 50 is the TPU's window group: the same launch as win_v3",
         "win_v3_g100": "g_block 100 is the TPU's window group: the same launch as win_v3",
         "glob_v3_q2048": "q_block 2048 is the TPU's query block: the same launch as glob_v3"}


def draw(rng, rows: int, n: int, heads: int):
    """One group's draws as the script makes them, straight into bf16: qkv
    (rows, n, heads * 256) and the packed table tcat (80, 256) * 0.02."""
    qkv = torch.from_numpy(rng.standard_normal((rows, n, heads * PAD))).to(torch.bfloat16)
    tcat = torch.from_numpy(rng.standard_normal((HD, 2 * LANES)) * 0.02).to(torch.bfloat16)
    return qkv, tcat


def operands(qkv: torch.Tensor, tcat: torch.Tensor, side: int, heads: int, hd: int = HD):
    """The port's operands of the script's: qkv with each head's first 3 * hd
    of its 256 columns ([q | k | v], as the port groups them), (rows, n,
    heads * 3 * hd), and the stacked tables [Rh; Rw] (2 (2 side - 1), hd) of
    the packed tcat (Rh in its columns 0.., Rw in 128..)."""
    rows, n, _ = qkv.shape
    grouped = qkv.view(rows, n, heads, -1)[..., :3 * hd].reshape(rows, n, heads * 3 * hd)
    r = 2 * side - 1
    tables = torch.cat([tcat[:, :r].T, tcat[:, LANES:LANES + r].T])
    return grouped.contiguous(), tables.contiguous()


def make_experiments(experiments: Dict, order: Iterable[str], device, heads: int, wb: int,
                     gb: int, groups: Iterable[str]) -> Dict[str, tuple]:
    """``{name: (fn, (qkv, tables))}`` for the experiments of the asked
    ``groups``, their inputs drawn in the script's group ``order``."""
    groups = set(groups)
    if not groups <= set(order):
        raise ValueError(f"unknown groups {sorted(groups - set(order))}: expected {tuple(order)}")
    rng = np.random.default_rng(0)
    shapes = {"win": (wb, NP, WS), "glob": (gb, GS * GS, GS)}
    ops = {}
    for group in order:
        if group in groups:
            rows, n, side = shapes[group]
            qkv, tcat = draw(rng, rows, n, heads)
            ops[group] = operands(qkv.to(device), tcat.to(device), side, heads)
    exps = {}
    for name, (group, form) in experiments.items():
        if group in ops:
            side = shapes[group][2]
            exps[name] = (partial(rel_attention_forms, kh=side, kw=side, heads=heads, hd=HD,
                                  nkeys=side * side, **form), ops[group])
    return exps


def experiments(device=None, HEADS: int = HEADS, WB: int = WB, GB: int = GB,
                groups: Iterable[str] = GROUPS) -> Dict[str, tuple]:
    """``{name: (fn, (qkv, tables))}`` for the script's experiments of the
    asked groups (``win``, ``glob``); each output is token-major (rows, n,
    HEADS * 80)."""
    return make_experiments(EXPERIMENTS, GROUPS, resolve_device(device), HEADS, WB, GB, groups)


def lines(name: str, r: Dict):
    return [f"[{name}] first call in {r['first_s']:.1f}s sum={r['sum']:.6e}",
            f"--- {name}: kernel device {r['us']:.1f} us/iter ---"]


def run(groups=None) -> Dict[str, Dict]:
    """The experiments of the asked groups (default: both) on the card;
    raises without one.  Returns ``{name: {"us", "first_s", "sum",
    "launches"}}``."""
    exps = experiments(resolve_device(None), groups=groups or GROUPS)
    results = run_experiments(exps, [n for n in NAMES if n in exps], lines, NOTES)
    print_summary("summary (kernel us/iter, batch-8 shapes):", results, width=18)
    return results


if __name__ == "__main__":
    run(sys.argv[1:])
