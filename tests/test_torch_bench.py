"""The port's bench (``samcarriestheburden_torch/bench.py``) on the CPU: its
analytic encoder count against the JAX bench's, the flop convention it
records (a known matmul at 2*m*n*k; K13's declared cost counted through the
custom op's flop formula), its ``--smoke`` JSON line, and its refusal to run
without a card unless asked for the CPU."""

import json
import time

import numpy as np
import pytest
import torch

import bench as jax_bench
from samcarriestheburden_torch import bench, config, kernels
from samcarriestheburden_torch.kernels import cost_probe as k13
from samcarriestheburden_tpu import config as jconfig

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

#: bench.py's top-level and detail keys, which the port's line keeps
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"vs_baseline_est", "vs_baseline_measured_cpu", "cpu_anchor",
               "embed_images_per_sec", "refined_masks_per_sec", "full_enhance_images_per_sec",
               "train_ms_per_step", "train_batch_hw", "amg_device_points_per_sec",
               "amg_points_per_batch", "enhance_batch", "seg_grid_hw", "encoder_batch",
               "attention", "encoder_dtype", "quantize", "unroll_blocks", "platform",
               "device_kind", "peak_tflops", "tflops_per_leg", "mfu", "flops_convention",
               "reference_implied_a100_mfu"}


@pytest.fixture(autouse=True)
def one_thread():
    """The smoke bench is hundreds of small CPU ops: one intra-op thread per
    test worker keeps it inside its time limit when the workers share the
    machine's cores (2 s alone, against 7 s with every core's thread)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("model", ["vit_t", "vit_b", "vit_h"])
def test_analytic_encoder_flops_equal_the_jax_bench(model, compact):
    ours = bench.analytic_encoder_flops(bench.CONFIGS[model](), compact)
    jcfg = {"vit_t": jconfig.sam_vit_t_config, "vit_b": jconfig.sam_vit_b_config,
            "vit_h": jconfig.sam_vit_h_config}[model]()
    assert ours == jax_bench.analytic_encoder_flops(jcfg, compact=compact)


def test_the_compact_layout_counts_fewer_rows_at_vit_h():
    cfg = config.sam_vit_h_config()
    assert bench.analytic_encoder_flops(cfg, True) < bench.analytic_encoder_flops(cfg, False)


@pytest.mark.parametrize("cfg, hw", [
    (dict(base_channels=4, n_last_channel=4), (48, 32)),
    (dict(base_channels=4, n_last_channel=6, bilinear=True), (50, 34)),
    (dict(base_channels=8, n_last_channel=8, n_classes=3), (37, 45))])
def test_analytic_unet_flops_equal_flop_counter_mode(cfg, hw):
    """The train leg's analytic count (2 per multiply-add of every
    convolution, the backward twice the forward but for the first
    convolution's input gradient) is what ``FlopCounterMode`` counts, odd
    sizes and the bilinear variant included."""
    from torch.utils.flop_counter import FlopCounterMode

    from samcarriestheburden_torch.models.unet import build_unet

    ucfg = config.UNetConfig(**cfg)
    model = build_unet(ucfg, device="cpu", seed=0).train()
    x = torch.randn(2, 1, *hw)
    with FlopCounterMode(display=False) as fc:
        model(x)
    fwd = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        model(x).sum().backward()
    assert (fwd, fc.get_total_flops()) == tuple(2 * f for f in bench.analytic_unet_flops(ucfg, hw))


def test_the_full_width_train_step_count():
    """``UNetConfig()`` at 384 x 224: 126.42 GF forward, 379.15 GF forward +
    backward a image, 6.07 TF a step of 16, 6.13 ms at the bf16 dense peak."""
    fwd, step = bench.analytic_unet_flops(config.UNetConfig(), config.UNET_INPUT_HW)
    assert (round(fwd / 1e9, 2), round(step / 1e9, 2)) == (126.42, 379.15)
    assert round(16 * step / 989e12 * 1e3, 2) == 6.13


def test_flops_convention_on_the_cpu():
    conv = bench.flops_convention_check(torch.device("cpu"))
    assert conv == {"matmul_2mnk_ratio": 1.0, "custom_kernel_cost_counted": True,
                    "scan_body_counted_once": None, "ok": True}


def test_the_probe_counts_its_declared_cost_and_is_x_times_two():
    """K13's custom op: ``x * 2.0`` bit for bit on the CPU (the plain
    version), ``declared`` operations under ``FlopCounterMode``, no launch."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((128, 128),
                                                                   dtype=np.float32)).bfloat16()
    kernels.reset_launches()
    with FlopCounterMode(display=False) as fc:
        out = k13.cost_probe(x, 777)
    assert fc.get_total_flops() == 777
    assert torch.equal(out, x * 2.0) and out.dtype == torch.bfloat16
    assert kernels.LAUNCHES["K13"] == 0
    assert torch.equal(torch.ops.samcarriestheburden.cost_probe(x, 1), k13.cost_probe_plain(x))


def test_smoke_line_on_the_cpu(capsys):
    t0 = time.perf_counter()
    result = bench.main(["--smoke", "--device", "cpu"])
    elapsed = time.perf_counter() - t0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(result))
    assert set(line) == TOP_KEYS and DETAIL_KEYS <= set(line["detail"])
    assert line["metric"] == "sam_vit_t_embed_refine_images_per_sec_per_chip_cpu_smoke"
    assert line["unit"] == "images/sec" and np.isfinite(line["value"]) and line["value"] > 0
    d = line["detail"]
    assert d["platform"] == "cpu" and d["device_kind"] is None and d["peak_tflops"] is None
    assert d["vs_baseline_est"] is None and line["vs_baseline"] is None
    assert d["mfu"]["encoder"] is None and d["mfu"]["train_step"] is None
    # the train-step leg: fp32 at batch 2 on the 48 x 32 grid, full width
    assert d["train_ms_per_step"] > 0 and d["train_batch_hw"] == [2, [48, 32]]
    assert d["tflops_per_leg"]["train_step"] == round(
        2 * bench.analytic_unet_flops(config.UNetConfig(), (48, 32))[1] / 1e12, 4)
    assert d["flops_convention"]["ok"] is True
    assert d["encoder_batch"] == 1 and d["enhance_batch"] == 1 and d["seg_grid_hw"] == [48, 32]
    assert d["tflops_per_leg"]["refine_17class_2round"] >= 0
    assert elapsed < 30, elapsed


def test_unroll_blocks_is_recorded(capsys):
    line = bench.main(["--smoke", "--device", "cpu", "--iters", "1", "--unroll_blocks"])
    assert line["detail"]["unroll_blocks"] is True


def test_without_a_card_the_bench_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--smoke"])


def test_the_unfused_formulations_refuse_int8():
    with pytest.raises(ValueError, match="no int8 mode"):
        bench.main(["--attention", "pallas", "--device", "cpu"])
