"""The port's attention experiment tools (``samcarriestheburden_torch/tools/
exp_attn.py``, ``exp_attn2.py``) against the JAX package's scripts of the
same names in ``tools/``, experiment by experiment, on the CPU at a small
size: the same seeded inputs (each script's own draws from
``np.random.default_rng(0)``, in its order of groups) through the JAX script,
with its Pallas kernels in interpret mode, and through the port's plain
versions of K5, K7 and K16 (``kernels/attention.py:rel_attention_plain`` with
the tools' ``softmax``, ``rel`` and ``exp``).

Size: ``HEADS`` 2 (so a head's offset in the padded and in the grouped
columns differs), ``WB`` 100 windows (``g_block`` 100 needs it), ``GB`` 1
grid; ``GN`` stays 4096, since the kernels' ``kh = kw = 64`` are literals.

Tolerance, by output (bf16, permuted from the port's token-major layout to
the scripts' (HEADS, rows, n, 80)): at most ``BF16_STEP`` x max |JAX| (one
bf16 step at the largest magnitude), with at least ``EQUAL_SHARE`` of the
entries equal and the median difference 0.  The port sums in another order
than XLA, so an output whose fp32 value lies near a bf16 rounding boundary
lands on the other neighbour now and then; v3 rounds the logits to bf16
before exp, which turns more of those fp32 differences into other bf16
probabilities.  Readings (x max |JAX|; equal share): v1 and v2 at most
0.0031, 0.9958-0.9996; v3 0.0022-0.0031, 0.9739 (windows) and 0.9889
(global); split, norel, noroll, noexp 0.0000-0.0030, 0.9934-0.9996; the
median 0 in every experiment.  Between two forms the max stays below one
bf16 step (0.0022-0.0047) but the equal share falls to 0.36-0.51, so
``test_the_softmax_forms_are_told_apart`` shows that this comparison tells
the tools' three forms apart.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from samcarriestheburden_torch import kernels
from samcarriestheburden_torch.kernels import attention as attn_k
from samcarriestheburden_torch.kernels import build
from samcarriestheburden_torch.tools import ab_attention, exp_attn, exp_attn2

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SIZE = dict(HEADS=2, WB=100, GB=1)
BF16_STEP = 2.0 ** -7
EQUAL_SHARE = 0.95

PORT = {"exp_attn": exp_attn, "exp_attn2": exp_attn2}
CASES = [(tool, name) for tool, mod in PORT.items() for name in mod.NAMES]
#: the kernel each experiment launches on the card
KERNEL = {"win_v1": "K16-v1", "win_v2": "K5", "win_v3": "K16-v3", "win_v3_g50": "K16-v3",
          "win_v3_g100": "K16-v3", "glob_v1": "K16-v1", "glob_v2": "K7", "glob_v3": "K16-v3",
          "glob_v3_q2048": "K16-v3", "glob_split_q1024": "K7", "glob_split_q2048": "K7",
          "win_full": "K5", "win_norel": "K16-norel", "win_noroll": "K16-noroll",
          "win_noexp": "K16-noexp"}


def _load_script(name: str, monkeypatch):
    """The JAX script ``tools/<name>.py`` as a module of its own (its
    ``sys.path`` inserts undone when ``monkeypatch`` ends)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_runs():
    """{tool: {name: (output, qkv, tcat)}} of each JAX script's ``main()`` at
    the small size, its Pallas kernels in interpret mode."""
    out = {tool: {} for tool in PORT}
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        for tool in PORT:
            mod = _load_script(tool, mp)
            for k, v in SIZE.items():
                mp.setattr(mod, k, v)

            def trace_run(name, fn, *args, runs=out[tool]):
                runs[name] = (np.asarray(fn(*args)), *args)
                return 0.0

            mp.setattr(mod, "_trace_run", trace_run)
            mp.setattr(sys, "argv", [f"{tool}.py"])
            mod.main()
    return out


@pytest.fixture(scope="module")
def port_experiments():
    return {tool: mod.experiments(device="cpu", **SIZE) for tool, mod in PORT.items()}


@pytest.fixture(scope="module")
def port_runs(port_experiments):
    """({tool: {name: output}}, launches): every experiment once on the CPU
    with the CUDA build refused (it raises if reached) and the launches
    counted from zero."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA build was reached for a CPU tensor")

    out = {tool: {} for tool in PORT}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "load", refuse)
        mp.setattr(build, "build", refuse)
        kernels.reset_launches()
        for tool, exps in port_experiments.items():
            for name, (fn, args) in exps.items():
                out[tool][name] = fn(*args)
        launches = dict(kernels.LAUNCHES)
    return out, launches


def _scripts_layout(out: torch.Tensor, heads: int) -> np.ndarray:
    """(rows, n, heads * 80) token-major -> the scripts' (heads, rows, n, 80), fp32."""
    rows, n, _ = out.shape
    return out.view(rows, n, heads, -1).permute(2, 0, 1, 3).float().numpy()


def _agreement(ours: np.ndarray, ref: np.ndarray):
    """(max |diff| / max |ref|, share of equal entries, median |diff|)."""
    diff = np.abs(ours.astype(np.float32) - ref.astype(np.float32))
    return diff.max() / np.abs(ref).max(), np.mean(diff == 0), np.median(diff)


def _agrees(ours, ref) -> bool:
    rel, equal, median = _agreement(ours, ref)
    return rel <= BF16_STEP and equal >= EQUAL_SHARE and median == 0


def test_the_port_keeps_every_experiment_name(jax_runs, port_experiments):
    for tool, mod in PORT.items():
        assert list(jax_runs[tool]) == list(mod.NAMES), tool
        assert list(port_experiments[tool]) == list(mod.NAMES), tool
    assert len(CASES) == 9 + 6 and set(KERNEL) == {name for _, name in CASES}


@pytest.mark.parametrize("tool,name", CASES, ids=[f"{t}-{n}" for t, n in CASES])
def test_experiment_matches_the_jax_script(jax_runs, port_runs, tool, name):
    ref = jax_runs[tool][name][0].astype(np.float32)
    ours = _scripts_layout(port_runs[0][tool][name], SIZE["HEADS"])
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    rel, equal, median = _agreement(ours, ref)
    assert rel <= BF16_STEP, rel
    assert equal >= EQUAL_SHARE, equal
    assert median == 0, median


@pytest.mark.parametrize("tool", sorted(PORT))
def test_the_operands_are_the_scripts_converted(jax_runs, port_experiments, tool):
    """The port draws what the script draws, bit for bit, and converts it:
    each head's first 240 of its 256 columns, the tables [Rh; Rw] from the
    packed tcat's columns 0.. and 128.."""
    heads, hd = SIZE["HEADS"], exp_attn.HD
    for name, (_, qkv, tcat) in jax_runs[tool].items():
        side = exp_attn.WS if name.startswith("win") else exp_attn.GS
        qkv = torch.from_numpy(np.array(qkv.astype(jnp.float32))).to(torch.bfloat16)
        tcat = torch.from_numpy(np.array(tcat.astype(jnp.float32))).to(torch.bfloat16)
        ours_qkv, ours_tab = port_experiments[tool][name][1]
        assert torch.equal(ours_qkv, exp_attn.operands(qkv, tcat, side, heads)[0]), name
        assert torch.equal(ours_tab, exp_attn.operands(qkv, tcat, side, heads)[1]), name
        for h in range(heads):
            assert torch.equal(ours_qkv[..., h * 3 * hd:(h + 1) * 3 * hd],
                               qkv[..., h * exp_attn.PAD:h * exp_attn.PAD + 3 * hd]), (name, h)
        r = 2 * side - 1
        assert ours_tab.shape == (2 * r, hd)
        assert torch.equal(ours_tab[:r], tcat[:, :r].T)
        assert torch.equal(ours_tab[r:], tcat[:, 128:128 + r].T)


@pytest.mark.parametrize("group", ["win", "glob"])
def test_the_softmax_forms_are_told_apart(jax_runs, port_runs, group):
    """The three forms differ by less than one bf16 step, so the max alone
    cannot tell them apart; with the equal share and the median the
    comparison above rejects every form but an experiment's own."""
    forms = {f: _scripts_layout(port_runs[0]["exp_attn"][f"{group}_{f}"], SIZE["HEADS"])
             for f in ("v1", "v2", "v3")}
    for f, ours in forms.items():
        for g in forms:
            ref = jax_runs["exp_attn"][f"{group}_{g}"][0]
            assert _agrees(ours, ref) == (f == g), (f, g, _agreement(ours, ref))


def test_noexp_is_the_mean_of_the_dead_slots_v(port_experiments, port_runs):
    """The dead slots' logits of -1e30 carry numerator and denominator alike:
    every output (live and dead rows) is the mean of the four dead slots' v
    rows, within one bf16 step (bf16(-1e30) is 1.00028e30); a version that
    skips them, as K5 does, computes something else."""
    qkv, tables = port_experiments["exp_attn2"]["win_noexp"][1]
    heads, hd, n = SIZE["HEADS"], exp_attn.HD, exp_attn.WS ** 2
    out = port_runs[0]["exp_attn2"]["win_noexp"].float()
    v = qkv.view(qkv.shape[0], qkv.shape[1], heads, 3, hd)[:, :, :, 2].float()
    mean_dead = v[:, n:].mean(1, keepdim=True).reshape(qkv.shape[0], 1, heads * hd)
    scale = out.abs().max().item()
    assert (out - mean_dead).abs().max().item() <= BF16_STEP * scale
    live_only = attn_k.rel_attention_plain(qkv, tables, heads=heads, hd=hd, kh=exp_attn.WS,
                                           kw=exp_attn.WS, nkeys=n, softmax="v2")
    assert (live_only.float() - out).abs().max().item() > 0.1 * scale


def _plain_before_the_forms(qkv, tables, *, heads, hd, kh, kw, nkeys, int8_qk=False,
                            int8_pv=False):
    """``rel_attention_plain`` as it was before the tools' forms came in."""
    s, n, _ = qkv.shape
    dt, dev = qkv.dtype, qkv.device
    scale = hd ** -0.5
    x = qkv.reshape(s, n, heads, 3 * hd).float()
    tab = tables.float()
    tok = torch.arange(n, device=dev)
    ph = (tok // kw).clamp(max=kh - 1)
    pw = tok % kw
    key = torch.arange(nkeys, device=dev)
    idx_h = (ph[:, None] - (key // kw)[None] + kh - 1).expand(s, n, nkeys)
    idx_w = (pw[:, None] - (key % kw)[None] + kw - 1 + 2 * kh - 1).expand(s, n, nkeys)
    out = torch.empty((s, n, heads, hd), dtype=dt, device=dev)
    for h in range(heads):
        q = x[:, :, h, :hd]
        k = x[:, :nkeys, h, hd:2 * hd]
        v = x[:, :nkeys, h, 2 * hd:]
        g = (q @ tab.T * (1.0 / scale)).to(dt).float()
        bias = g.gather(2, idx_h) + g.gather(2, idx_w)
        qk = attn_k.int8_qk_plain(q, k) if int8_qk else q @ k.transpose(1, 2)
        logits = (qk + bias) * scale
        p = torch.softmax(logits, dim=-1)
        out[:, :, h] = (attn_k.int8_pv_plain(p, v) if int8_pv else p.to(dt).float() @ v).to(dt)
    return out.reshape(s, n, heads * hd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape,int8_qk,int8_pv",
                         [((5, 5, 25), False, False), ((8, 8, 64), False, False),
                          ((8, 8, 64), True, False), ((8, 8, 64), True, True)],
                         ids=["window", "global", "int8_qk", "int8_pv"])
def test_the_plain_defaults_are_unchanged(rng, dtype, shape, int8_qk, int8_pv):
    """K5's and K7's plain version (the defaults: v1, full, exp) gives the same
    bits as before the forms, dead slots included; ``softmax="v1"`` spelled out
    is the same call."""
    kh, kw, nkeys = shape
    heads, hd = 2, 16
    n = -(-nkeys // 8) * 8 if kh == 5 else nkeys
    qkv = torch.from_numpy(rng.standard_normal((3, n, heads * 3 * hd)).astype(np.float32)).to(dtype)
    tables = torch.from_numpy(0.3 * rng.standard_normal((2 * kh - 1 + 2 * kw - 1, hd))
                              .astype(np.float32)).to(dtype)
    kw_ = dict(heads=heads, hd=hd, kh=kh, kw=kw, nkeys=nkeys, int8_qk=int8_qk, int8_pv=int8_pv)
    want = _plain_before_the_forms(qkv, tables, **kw_)
    assert torch.equal(attn_k.rel_attention_plain(qkv, tables, **kw_), want)
    assert torch.equal(attn_k.rel_attention_plain(qkv, tables, softmax="v1", rel="full",
                                                  exp=True, **kw_), want)


def test_each_experiment_names_its_kernel():
    """The card's kernel of each experiment (``forms_kernel``): K5 and K7 for
    v2 with the full rel term and exp, K16's instance for every other form."""
    for tool, mod in PORT.items():
        for name, (group, form) in mod.EXPERIMENTS.items():
            n = exp_attn.NP if group == "win" else exp_attn.GS ** 2
            assert attn_k.forms_kernel(n, **form) == KERNEL[name], (tool, name)


@pytest.mark.parametrize("form,n,match", [
    (dict(softmax="v1", rel="none"), 200, "no kernel"),
    (dict(softmax="v3", exp=False), 200, "no kernel"),
    (dict(softmax="v2", rel="none"), 4096, "windows"),
    (dict(softmax="v2", exp=False), 4096, "windows")], ids=str)
def test_forms_without_a_kernel_are_refused(form, n, match):
    with pytest.raises(ValueError, match=match):
        attn_k.forms_kernel(n, **form)


@pytest.mark.parametrize("kw_", [dict(softmax="v4"), dict(rel="roll"),
                                 dict(softmax="v2", int8_qk=True)], ids=str)
def test_the_plain_version_refuses_unknown_forms(kw_):
    qkv, tables = torch.zeros(1, 4, 2 * 3 * 16), torch.zeros(6, 16)
    with pytest.raises(ValueError):
        attn_k.rel_attention_plain(qkv, tables, heads=2, hd=16, kh=2, kw=2, nkeys=4, **kw_)


def test_k16_never_reaches_the_build_on_cpu(port_runs):
    """On CPU tensors every experiment runs its plain version: the build is
    not touched (``port_runs`` refuses it) and no launch is counted."""
    outputs, launches = port_runs
    for tool in PORT:
        for name, out in outputs[tool].items():
            assert torch.isfinite(out.float()).all(), (tool, name)
    assert not any(launches.values()), launches


@pytest.mark.parametrize("tool", sorted(PORT))
def test_the_tools_run_on_the_card_only(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT[tool].run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT[tool].experiments()


def test_the_checkout_ab_runs_on_the_card_only(monkeypatch):
    """``tools/ab_attention`` (K5, the global family and K12 of two checkouts,
    in turns, with the digests of their outputs) raises before it starts a
    turn when there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ab_attention.subprocess, "run", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_attention.run(str(ROOT))


K12_SMALL = dict(wb=8, ws=5, e=32, heads=2, grid=8)


def test_the_k12_case_is_seeded_and_zeroes_the_pad_tokens():
    """``ab_attention.k12_case`` (the A/B tool's K12 inputs) makes the same
    tensors for the same seed and others for another; the tokens of a window
    that lie past the image's grid are zero and the others not, at a small
    size (two images of 8 x 8 tokens in windows of 5 x 5: 2 x 2 windows each)."""
    args, kw = ab_attention.k12_case("cpu", **K12_SMALL)
    again, _ = ab_attention.k12_case("cpu", **K12_SMALL)
    other, _ = ab_attention.k12_case("cpu", **K12_SMALL, seed=1)
    assert kw == dict(ws=5, heads=2)
    assert all(torch.equal(a, b) for a, b in zip(args, again))
    assert not torch.equal(args[0], other[0]) and not torch.equal(args[1], other[1])
    xn, qkv_w, qkv_b, proj_w, tables = args
    assert xn.shape == (8, 25, 32) and xn.dtype == torch.bfloat16
    assert qkv_w.shape == (96, 32) and qkv_b.shape == (96,) and qkv_b.dtype == torch.float32
    assert proj_w.shape == (32, 32) and tables.shape == (18, 16)
    for w in range(8):
        i, j = divmod(w % 4, 2)
        for t in range(25):
            pad = i * 5 + t // 5 >= 8 or j * 5 + t % 5 >= 8
            assert (xn[w, t] == 0).all().item() == pad, (w, t)
    assert 0.01 < qkv_w.float().std().item() < 0.03


def test_the_k12_case_runs_the_plain_version_on_cpu():
    """On CPU tensors the tool's K12 case is K12's plain version, finite, and
    the turn script builds K12's source and takes the case from this module."""
    args, kw = ab_attention.k12_case("cpu", **K12_SMALL)
    out = attn_k.window_block_attention(*args, **kw)
    assert torch.equal(out, attn_k.window_block_attention_plain(*args, **kw))
    assert torch.isfinite(out.float()).all() and out.float().abs().max().item() > 0
    assert '"block_attention"' in ab_attention.TURN and "k12_case" in ab_attention.TURN
    assert '"K12"' in ab_attention.TURN


def test_a_group_asked_alone_draws_first():
    """As in the scripts, the numbers drawn depend on the groups asked for:
    ``exp_attn`` draws the windows first, ``exp_attn2`` the grids first."""
    both = exp_attn.experiments("cpu", HEADS=1, WB=25, GB=1)
    alone = exp_attn.experiments("cpu", HEADS=1, WB=25, GB=1, groups=["glob"])
    assert list(alone) == [n for n in exp_attn.NAMES if n.startswith("glob")]
    assert not torch.equal(alone["glob_v1"][1][0], both["glob_v1"][1][0])
    first = exp_attn2.experiments("cpu", HEADS=1, WB=25, GB=1, groups=["glob"])
    assert torch.equal(first["glob_split_q1024"][1][0],
                       exp_attn2.experiments("cpu", HEADS=1, WB=25, GB=1)["glob_split_q1024"][1][0])
    with pytest.raises(ValueError, match="unknown groups"):
        exp_attn.experiments("cpu", groups=["mlp"])
