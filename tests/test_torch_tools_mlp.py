"""The port's int8-MLP and GEMM experiment tools (``samcarriestheburden_torch/
tools/exp_int8.py``, ``exp_mlp2.py``, ``exp_3d.py``) against the JAX
package's scripts of the same names in ``tools/``, experiment by experiment,
on the CPU at a small size: the same seeded inputs (each script's own draws
from ``np.random.default_rng(0)``) through the JAX script, with its Pallas
kernels in interpret mode, and through the port's plain versions of K3, K4,
K14 and K15 and the library calls.

Sizes: ``exp_int8`` T=512, E=128, M=512 (the script's row blocks of 256 and
512 both tile it); ``exp_mlp2`` T=1024 (its blocks of 512 and 1024);
``exp_3d`` keeps WB x N = 100 x 196 (its ``dot2d`` hard-codes 25 blocks of
784 rows) with E=128, M=256.  K15's chunks of M=512 are 64 to 512 columns,
which the plain version takes (the card's kernel needs 128).

Tolerances, by output:

* int32 products (``*_dot_int8``): equal.  The JAX ``pallas_dot_int8``
  returns its int32 as fp32; every value here is below 2^24, so the port's
  int32 cast to fp32 must equal it.
* fp32 products (``pallas_dot_bf16``): ``FP32_TOL`` x max |JAX|, the order
  of the fp32 sums (the port's plain version sums in float64; reading 1.2e-7).
* the library's bf16 product (``xla_dot_bf16``: ``torch.matmul`` returns bf16
  where the JAX dot returns fp32): ``BF16_STEP`` x max |JAX|, one bf16 step at
  the largest magnitude (reading 3.8e-3: the CPU's blocked bf16 sums).
* the MLP outputs (bf16, int8 inside): ``STEP_TOL`` x max |JAX|, the bound
  ``tests/test_torch_quant.py`` holds K4 to (one int8 rounding tie that lands
  on the other step, then the bf16 rounding; readings up to 1.64e-3), with at
  least ``EQUAL_SHARE`` of the entries equal (readings 0.99981-1) and the
  median difference 0.
* the bf16 products of ``exp_3d``: ``BF16_STEP`` x max |JAX| (an fp32 sum
  rounding to the other bf16 neighbour; reading 3.2e-3) and ``EQUAL_SHARE``
  (reading 0.99995).
"""

import ast
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from samcarriestheburden_torch import kernels
from samcarriestheburden_torch.kernels import build
from samcarriestheburden_torch.kernels import gemm as gemm_k
from samcarriestheburden_torch.kernels import quant as quant_k
from samcarriestheburden_torch.tools import exp_3d, exp_int8, exp_mlp2

ROOT = Path(__file__).resolve().parent.parent
INT8_SIZE = dict(T=512, E=128, M=512)
MLP2_SIZE = dict(T=1024, E=128, M=512)
D3_SIZE = dict(E=128, M=256)

FP32_TOL = 1e-6
BF16_STEP = 2.0 ** -7
STEP_TOL = 2e-3
EQUAL_SHARE = 0.999

PORT = {"exp_int8": exp_int8, "exp_mlp2": exp_mlp2, "exp_3d": exp_3d}
SIZES = {"exp_int8": INT8_SIZE, "exp_mlp2": MLP2_SIZE, "exp_3d": D3_SIZE}
CASES = [(tool, name) for tool, mod in PORT.items() for name in mod.NAMES]


def _load_script(name: str, monkeypatch):
    """The JAX script ``tools/<name>.py`` as a module of its own (its
    ``sys.path`` inserts undone when ``monkeypatch`` ends)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorder(out: dict):
    def trace_run(name, fn, *args):
        out[name] = np.asarray(fn(*args))
        return 0.0
    return trace_run


@pytest.fixture(scope="module")
def jax_outputs():
    """{tool: {name: output}} of each JAX script at the small sizes, its
    Pallas kernels in interpret mode."""
    out = {"exp_int8": {}, "exp_mlp2": {}, "exp_3d": {}}
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        for tool in ("exp_int8", "exp_mlp2"):
            mod = _load_script(tool, mp)
            for k, v in SIZES[tool].items():
                mp.setattr(mod, k, v)
            mp.setattr(mod, "_trace_run", _recorder(out[tool]))
            mp.setattr(sys, "argv", [f"{tool}.py"])
            mod.main()
        mod = _load_script("exp_3d", mp)
        e, m = D3_SIZE["E"], D3_SIZE["M"]
        rng = np.random.default_rng(0)
        x3 = jnp.asarray(rng.standard_normal((mod.WB, mod.N, e)), jnp.bfloat16)
        mp.setattr(mod, "E", e)
        mp.setattr(mod, "M", m)
        mp.setattr(mod, "w", jnp.asarray(rng.standard_normal((e, m)) * 0.02, jnp.bfloat16))
        out["exp_3d"] = {"dot3d": np.asarray(mod.dot3d(x3)),
                         "dotreshape": np.asarray(mod.dotreshape(x3)),
                         "dot2d": np.asarray(mod.dot2d(x3.reshape(-1, e)))}
    return out


@pytest.fixture(scope="module")
def port_experiments():
    return {tool: mod.experiments(device="cpu", **SIZES[tool]) for tool, mod in PORT.items()}


def _exp_3d_names():
    """The names the JAX ``exp_3d`` runs: the list its ``__main__`` block
    falls back to."""
    tree = ast.parse((ROOT / "tools" / "exp_3d.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or) \
                and isinstance(node.values[-1], ast.List):
            return [elt.value for elt in node.values[-1].elts]
    raise AssertionError("exp_3d.py names no default experiments")


def test_the_port_keeps_every_experiment_name(jax_outputs, port_experiments):
    assert list(jax_outputs["exp_int8"]) == list(exp_int8.NAMES)
    assert list(jax_outputs["exp_mlp2"]) == list(exp_mlp2.NAMES)
    assert _exp_3d_names() == list(exp_3d.NAMES)
    for tool, mod in PORT.items():
        assert list(port_experiments[tool]) == list(mod.NAMES), tool
    assert {tool for tool, _ in CASES} == set(PORT) and len(CASES) == 17 + 5 + 3


@pytest.mark.parametrize("tool,name", CASES, ids=[f"{t}-{n}" for t, n in CASES])
def test_experiment_matches_the_jax_script(jax_outputs, port_experiments, tool, name):
    fn, args = port_experiments[tool][name]
    ours = fn(*args)
    ref = jax_outputs[tool][name]
    assert tuple(ours.shape) == ref.shape, (ours.shape, ref.shape)
    if name.endswith("dot_int8"):
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy().astype(ref.dtype), ref)
        return
    ours = ours.float().numpy()
    ref = ref.astype(np.float32)
    scale = np.abs(ref).max()
    diff = np.abs(ours - ref)
    if name == "pallas_dot_bf16":
        assert diff.max() <= FP32_TOL * scale, (diff.max(), scale)
    elif name == "xla_dot_bf16":
        assert diff.max() <= BF16_STEP * scale, (diff.max(), scale)
    else:
        tol = BF16_STEP if tool == "exp_3d" else STEP_TOL
        assert diff.max() <= tol * scale, (diff.max(), scale)
        assert np.mean(diff == 0) >= EQUAL_SHARE, np.mean(diff == 0)
        assert np.median(diff) == 0


def test_the_variants_compute_different_functions(port_experiments):
    """The checks above can see each flag: the K15 experiments' outputs differ
    from K4's (``mlp_int8_preq``) by more than the comparison's tolerance,
    except ``diag_poly`` (K4's arithmetic) and the t_block twins."""
    exps = port_experiments["exp_int8"]
    out = {name: fn(*args).float() for name, (fn, args) in exps.items()
           if name.startswith(("mlp_int8", "diag"))}
    k4 = out["mlp_int8_preq"]
    assert torch.equal(out["diag_poly"], k4) and torch.equal(out["diag_poly_t512"], k4)
    assert torch.equal(out["mlp_int8_chunk4_t512"], out["mlp_int8_chunk4"])
    scale = k4.abs().max().item()
    for name in ("mlp_int8_chunk2", "mlp_int8_chunk4", "mlp_int8_chunk8", "diag_erf",
                 "diag_sigmoid", "diag_relu", "diag_erf_fixedscale", "diag_relu_fixedscale"):
        assert (out[name] - k4).abs().max().item() > STEP_TOL * scale, name


@pytest.mark.parametrize("gelu", quant_k.GELU_IMPLS)
def test_k15_plain_is_k4_at_k4s_settings(rng, gelu):
    t, e, m = 64, 32, 256
    x = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32) * 3).to(torch.bfloat16)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(e).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.standard_normal(e).astype(np.float32))
    w1q, s1 = quant_k.quantize_weight(torch.from_numpy(rng.standard_normal((m, e))))
    w2q, s2 = quant_k.quantize_weight(torch.from_numpy(rng.standard_normal((e, m))))
    b1 = torch.from_numpy(0.1 * rng.standard_normal(m).astype(np.float32))
    b2 = torch.from_numpy(0.1 * rng.standard_normal(e).astype(np.float32))
    args = (x, g, b, w1q, s1, b1, w2q, s2, b2)
    k4 = quant_k.ln_mlp_residual_int8_plain(*args, gelu=gelu)
    k15 = quant_k.ln_mlp_residual_int8_exp(*args, chunks=1, act=gelu, rq="div")
    assert torch.equal(k15, k4)
    assert torch.equal(quant_k.ln_mlp_residual_int8_exp_plain(*args, act=gelu), k4)
    # one scale per (row, chunk) is another function
    assert not torch.equal(quant_k.ln_mlp_residual_int8_exp(*args, chunks=4, act=gelu), k4)


def test_row_quant_recip_matches_the_script(rng, monkeypatch):
    """``rq='recip'`` as ``tools/exp_mlp2.py:_rq_recip``: q = rint(x * (127 /
    a)), scale a * fp32(1/127), bit for bit, ties and a zero row included."""
    mod = _load_script("exp_mlp2", monkeypatch)
    x = (rng.standard_normal((16, 96)) * rng.uniform(0.01, 30.0, (16, 1))).astype(np.float32)
    x[2] = 0.0
    x[3, :4] = [0.5, 1.5, 2.5, -3.5]
    x[3, 4] = 127.0
    jq, js = mod._rq_recip(jnp.asarray(x))
    q, s = quant_k.row_quant_recip(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).astype(np.float32))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jq, js = mod._rq_div(jnp.asarray(x))
    q, s = quant_k.row_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).astype(np.float32))


@pytest.mark.parametrize("chunks", [3, 5, 0])
def test_k15_refuses_chunks_that_do_not_divide_m(chunks):
    t, e, m = 8, 16, 64
    w1q, s1 = quant_k.quantize_weight(torch.randn(m, e))
    w2q, s2 = quant_k.quantize_weight(torch.randn(e, m))
    args = (torch.randn(t, e), torch.ones(e), torch.zeros(e), w1q, s1, torch.zeros(m), w2q, s2,
            torch.zeros(e))
    for fn in (quant_k.ln_mlp_residual_int8_exp, quant_k.ln_mlp_residual_int8_exp_plain):
        with pytest.raises(ValueError, match="chunks"):
            fn(*args, chunks=chunks)


@pytest.mark.parametrize("flag", [dict(act="tanh"), dict(rq="floor")], ids=str)
def test_k15_refuses_unknown_flags(flag):
    w1q = torch.zeros(32, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match=next(iter(flag))):
        quant_k.ln_mlp_residual_int8_exp(torch.zeros(2, 16), None, None, w1q, *[None] * 5,
                                         **flag)


@pytest.mark.parametrize("out_dtype", list(gemm_k.MODES), ids=str)
def test_k14_plain_is_the_product(rng, out_dtype):
    """K14's plain version against numpy in float64; the int8 one exact at the
    largest accumulant (127^2 x 1280, beyond fp32's 2^24)."""
    in_dtype = gemm_k.MODES[out_dtype][0]
    if in_dtype == torch.int8:
        a = torch.from_numpy(rng.integers(-127, 128, (40, 1280)).astype(np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (24, 1280)).astype(np.int8))
        a[0], w[0] = 127, 127
        want = a.numpy().astype(np.int64) @ w.numpy().astype(np.int64).T
        got = gemm_k.dot(a, w, out_dtype)
        assert got.dtype == torch.int32 and int(got[0, 0]) == 127 * 127 * 1280
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        a = torch.from_numpy(rng.standard_normal((40, 96)).astype(np.float32)).to(in_dtype)
        w = torch.from_numpy(rng.standard_normal((24, 96)).astype(np.float32)).to(in_dtype)
        want = a.double().numpy() @ w.double().numpy().T
        got = gemm_k.dot(a, w, out_dtype)
        assert got.dtype == out_dtype
        np.testing.assert_array_equal(got.double().numpy(),
                                      torch.from_numpy(want).to(out_dtype).double().numpy())
    with pytest.raises(ValueError, match="operands"):
        gemm_k.dot(a.float(), w.float(), out_dtype)


def test_k14_and_k15_never_reach_the_compiler_on_cpu(monkeypatch, port_experiments):
    """On CPU tensors every experiment runs plain versions and library calls:
    the build is not touched and no launch is counted."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA build was reached for a CPU tensor")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    kernels.reset_launches()
    for tool in PORT:
        for name, (fn, args) in port_experiments[tool].items():
            assert torch.isfinite(fn(*args).float()).all(), (tool, name)
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


@pytest.mark.parametrize("tool", sorted(PORT))
def test_the_tools_run_on_the_card_only(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT[tool].run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT[tool].experiments()
