"""Where the attention kernels' time goes: the bias split and the windowed
kernel's ablations.  The port of the JAX package's ``tools/exp_attn2.py``.

    python -m samcarriestheburden_torch.tools.exp_attn2 [glob win]   (default: both)

Times at the script's shapes (those of ``exp_attn``) and prints each
experiment's device time per call (CUDA events over ``ITERS`` calls) and a
summary:

* ``glob_split_q1024``, ``glob_split_q2048``: the global attention with its
  rel bias as two small products added to the width-80 q . k, in the v2 form:
  K7's function (the split only orders its fp32 sums otherwise), so K7; the
  query block is the TPU's, so both run the same launch;
* ``win_full``: the windowed attention in the v2 form: K5;
* ``win_norel``: no rel term: K16-norel;
* ``win_noroll``: every query's rel terms at cell (0, 0): K16-noroll;
* ``win_noexp``: ``logits - max`` in place of exp: K16-noexp.  The dead
  slots keep their logit of -1e30 and their v rows, so every output is close
  to the mean of the four dead slots' v: the function the TPU kernel computes.

Inputs are the script's, from ``np.random.default_rng(0)`` in its draw order
(grids, then windows, each only if asked for), converted as ``exp_attn``'s.
"""

from __future__ import annotations

import sys
from typing import Dict, Iterable

from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.tools.exp_attn import (GB, HEADS, WB, lines, make_experiments)
from samcarriestheburden_torch.tools.timing import print_summary, run_experiments

#: name: (group, form): the script's experiments in its order
EXPERIMENTS = {
    "glob_split_q1024": ("glob", dict(softmax="v2")),
    "glob_split_q2048": ("glob", dict(softmax="v2")),
    "win_full": ("win", dict(softmax="v2")),
    "win_norel": ("win", dict(softmax="v2", rel="none")),
    "win_noroll": ("win", dict(softmax="v2", rel="base0")),
    "win_noexp": ("win", dict(softmax="v2", exp=False)),
}
NAMES = tuple(EXPERIMENTS)
GROUPS = ("glob", "win")         # the script's draw order
NOTES = {"glob_split_q1024": "the bias split is K7's function: K7's launch",
         "glob_split_q2048": "q_block 2048 is the TPU's query block: the same launch as "
                             "glob_split_q1024"}


def experiments(device=None, HEADS: int = HEADS, WB: int = WB, GB: int = GB,
                groups: Iterable[str] = GROUPS) -> Dict[str, tuple]:
    """``{name: (fn, (qkv, tables))}`` for the script's experiments of the
    asked groups (``glob``, ``win``); each output is token-major (rows, n,
    HEADS * 80)."""
    return make_experiments(EXPERIMENTS, GROUPS, resolve_device(device), HEADS, WB, GB, groups)


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
