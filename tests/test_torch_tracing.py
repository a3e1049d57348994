"""The port's spans and counters (``samcarriestheburden_torch/profiling.py``)
on the CPU: nothing recorded and one shared no-op while recording is off;
parents, threads and self times while it is on; the spans the loops, the
enhance engine, the trainer and K4's wrapper record; and their charging on
a hand-made device trace (``benchmark/harness/program_trace.py``)."""

import itertools
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from samcarriestheburden_torch import kernels, profiling
from samcarriestheburden_torch.cli.save_refined_segmentations import refine_images
from samcarriestheburden_torch.config import TrainConfig, UNetConfig, sam_vit_t_config
from samcarriestheburden_torch.data.h5io import MemoryEmbeddings, MemoryMasks
from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead
from samcarriestheburden_torch.engine.embeddings import encode_images, make_serving_encoder
from samcarriestheburden_torch.engine.refinement import SamSegRefiner, SegEnhance
from samcarriestheburden_torch.kernels import quant
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_torch.models.unet import build_unet
from samcarriestheburden_torch.profiling import count, recording, span
from samcarriestheburden_torch.train.loop import UNetTrainer

torch.set_num_threads(1)
# the benchmark's harness, after every other entry so that it shadows nothing
sys.path.append(str(Path(__file__).resolve().parents[1] / "benchmark"))
from harness import program_trace  # noqa: E402

GRID = (48, 32)


def names(rec):
    return [s.name for s in rec.spans]


def boom(*a, **k):
    raise AssertionError("called while recording is off")


def test_recording_off_records_nothing_and_shares_one_noop(monkeypatch):
    monkeypatch.setattr(profiling, "time", SimpleNamespace(perf_counter_ns=boom))
    monkeypatch.setattr(profiling, "threading", SimpleNamespace(get_ident=boom, local=boom))
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    a, b = span("encode_images.dispatch", batch=3), span("enhance.decode", round=2)
    assert a is b and not profiling.active()

    def spin(batches):
        for i in batches:
            with span("kernels.K4", batch=i):
                count("encode_images.batches_waited")

    def kept(fn):
        """Memory blocks still held after ``fn()``."""
        before = sys.getallocatedblocks()
        fn()
        return sys.getallocatedblocks() - before

    batches = list(range(1000, 3000))
    spin(batches)                       # the interpreter's caches, made once
    assert kept(lambda: spin(batches)) == kept(lambda: None)
    monkeypatch.undo()
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {} and rec.summary() == {}


def test_nesting_gives_parents_threads_and_self_times(monkeypatch):
    clock = itertools.count(0, 10)
    monkeypatch.setattr(profiling, "time", SimpleNamespace(perf_counter_ns=clock.__next__))
    with recording() as rec:
        assert profiling.active()
        with span("outer", batch=0):            # 0 .. 70
            with span("a"):                     # 10 .. 20
                pass
            with span("b", round=2):            # 30 .. 60
                with span("c"):                 # 40 .. 50
                    count("n")
                count("n", 2)
    assert not profiling.active()
    assert names(rec) == ["outer", "a", "b", "c"]
    assert [s.parent for s in rec.spans] == [-1, 0, 0, 2]
    assert [(s.start_ns, s.end_ns) for s in rec.spans] == [(0, 70), (10, 20), (30, 60),
                                                          (40, 50)]
    assert rec.self_ns() == [70 - 10 - 30, 10, 30 - 10, 10]
    assert (rec.spans[0].batch, rec.spans[2].round, rec.spans[1].batch) == (0, 2, None)
    assert rec.counters == {"n": 3}
    got = rec.summary()
    assert got["outer"] == pytest.approx({"total_s": 70e-9, "self_s": 30e-9, "count": 1,
                                          "mean_ms": 70e-6})
    assert got["n"] == {"count": 3}

    # a span of another thread opens at its top level, whatever the main
    # thread has open; a recording inside another takes the spans until it ends
    monkeypatch.undo()
    with recording() as rec:
        with span("main"):
            t = threading.Thread(target=lambda: span("worker").__enter__().__exit__(
                None, None, None))
            t.start()
            t.join()
            with recording() as inner:
                with span("inside"):
                    pass
        with span("after"):
            pass
    assert names(rec) == ["main", "worker", "after"] and names(inner) == ["inside"]
    main, worker, _ = rec.spans
    assert worker.parent == -1 and worker.thread == t.ident != main.thread
    assert main.thread == threading.get_ident()


@pytest.fixture(scope="module")
def sam():
    return build_sam(sam_vit_t_config(), device="cpu", seed=0)


def test_encode_images_records_its_batches(sam):
    encode, packed = make_serving_encoder(sam, torch.float32)
    rng = np.random.default_rng(1)
    images = {f"s{i}": rng.integers(0, 256, (90, 60), dtype=np.uint8) for i in range(5)}
    with recording() as rec:
        encode_images(encode, packed, list(images), images.__getitem__,
                      MemoryEmbeddings(sam.img_size), img_size=sam.img_size, device="cpu",
                      batch_size=2, loader_threads=2)
    for name in ("load_wait", "dispatch", "drain"):
        got = [s.batch for s in rec.spans if s.name == f"encode_images.{name}"]
        assert got == [0, 1, 2], name
    assert 0 <= rec.counters.get("encode_images.batches_waited", 0) <= 3
    assert "kernels.K4" not in names(rec)


def test_k4_spans_equal_its_launches(sam, monkeypatch):
    """One ``kernels.K4`` span a launch: none on the CPU's plain path (a tiny
    int8 encode launches nothing), and one a call on the launch path (meta
    tensors, the launch itself stubbed)."""
    encode, packed = make_serving_encoder(sam, torch.float32, quantize="int8")
    imgs = torch.zeros((1, 3, sam.img_size, sam.img_size), dtype=torch.uint8)
    sizes = torch.tensor([[sam.img_size, 90]], dtype=torch.int32)
    before = kernels.LAUNCHES["K4"]
    with recording() as rec:
        encode(packed, imgs, sizes)
    assert names(rec).count("kernels.K4") == kernels.LAUNCHES["K4"] - before == 0

    monkeypatch.setattr(quant, "check_cuda", lambda *a: None)
    monkeypatch.setattr(quant, "ptr", lambda t: 0)
    monkeypatch.setattr(quant, "stream", lambda: 0)
    monkeypatch.setattr(quant, "_lib", lambda: SimpleNamespace(
        k4_ln_mlp_residual_int8=lambda *a: 0))
    monkeypatch.setitem(kernels.LAUNCHES, "K4", 0)
    e, m = 32, 64

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    args = (meta(8, e, dtype=torch.bfloat16), meta(e), meta(e), meta(m, e, dtype=torch.int8),
            meta(m), meta(m), meta(e, m, dtype=torch.int8), meta(e), meta(e))
    with recording() as rec:
        with span("models.encode"):
            for _ in range(3):
                assert quant.ln_mlp_residual_int8(*args).shape == (8, e)
    assert names(rec) == ["models.encode"] + ["kernels.K4"] * 3 == \
        ["models.encode"] + ["kernels.K4"] * kernels.LAUNCHES["K4"]
    assert all(s.parent == 0 for s in rec.spans[1:])


def test_refine_images_records_each_round_of_each_batch(sam):
    rng = np.random.default_rng(2)
    stems = ["a", "b", "c"]
    store = MemoryEmbeddings(sam.img_size)
    for s in stems:
        store.write(s, rng.standard_normal((1, 16, 8, 8)).astype(np.float32), (96, 64), (128, 85))
    unet = build_unet(UNetConfig(base_channels=4, n_last_channel=4), device="cpu", seed=0)
    with torch.no_grad():                       # sparse classes, so that some are seeded
        unet.outc.conv.weight.mul_(3)
        unet.outc.conv.bias.fill_(-3)
    head = SamMaskDecoderHead(None, "vit_t", store, device="cpu", params=sam)
    enh = SegEnhance(SamSegRefiner(head, prompts2use=[["box"], ["pos_points", "neg_points"]]),
                     "highest_probability", "dilation", "square", 4)
    images = {s: rng.integers(0, 256, GRID, dtype=np.uint8) for s in stems}
    masks = MemoryMasks()
    with recording() as rec:
        refine_images(unet, enh, stems, images.__getitem__, masks, img_batch=2)
    assert masks.stems() == stems
    by = {n: [s for s in rec.spans if s.name == n] for n in set(names(rec))}
    assert [s.round for s in by["enhance.decode"]] == [1, 2, 1, 2]
    assert [s.round for s in by["enhance.prompts"]] == [1, 2, 1, 2]
    for name in ("enhance.select", "enhance.morph", "enhance.features", "enhance.postprocess"):
        assert len(by[name]) == 2, name
    assert [s.batch for s in by["refine_images.unet"]] == [0, 1]
    assert [s.batch for s in by["refine_images.flush"]] == [0, 1]


@pytest.mark.parametrize("epoch_scan", [True, False])
def test_train_epoch_records_one_augment_and_one_step_a_step(epoch_scan):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (6, 1, *GRID)).astype(np.float32)
    y = (rng.uniform(0, 1, (6, 3, *GRID)) > 0.7).astype(np.uint8)
    cfg = TrainConfig(batch_size=2, epochs=2, sample_mode="shuffle", epoch_scan=epoch_scan)
    trainer = UNetTrainer(UNetConfig(n_classes=3, base_channels=4, n_last_channel=4), cfg,
                          device="cpu")
    with recording() as rec:
        trainer.train_epoch(x, y, 0)
    steps = len(x) // cfg.batch_size
    for name in ("trainer.augment", "trainer.step"):
        assert [s.batch for s in rec.spans if s.name == name] == list(range(steps)), name
    assert names(rec).count("trainer.plan") == 1
    assert names(rec).count("trainer.readback") == (1 if epoch_scan else steps)


# ---------------------------------------------------------------------------
# charging device time on a hand-made Chrome trace
# ---------------------------------------------------------------------------


def kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"stream": 7, "correlation": corr}}


def launch(ts, corr, tid, dur=2.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def test_device_time_goes_to_the_innermost_span_of_the_launching_thread():
    main, other = 0x7F00_1234_5000, 0x7F00_A000_0000       # Python idents
    tid_main = 4242
    Span = program_trace.Span
    spans = [Span(0, 100, "encode_images.dispatch", main, -1, 0, None),
             Span(10, 40, "kernels.K4", main, 0, None, None),
             Span(60, 90, "kernels.K4", main, 0, None, None),
             Span(0, 100, "loader", other, -1, None, None)]
    events = [
        kernel("gemm_a", 200, 30, 1), launch(15, 1, tid_main),                # in K4 #1
        kernel("gemm_b", 230, 10, 2), launch(38, 2, tid_main),                # in K4 #1
        kernel("ln", 240, 5, 3), launch(50, 3, tid_main),                     # dispatch only
        kernel("gemm_a", 250, 30, 4), launch(70, 4, tid_main),                # in K4 #2
        kernel("copy", 260, 20, 5, cat="gpu_memcpy"),
        launch(20, 5, program_trace.trace_tid(other)),                       # other thread
        kernel("late", 290, 8, 6), launch(95, 6, 99),            # a thread with no span
        kernel("orphan", 300, 4, 7),                                         # no launch
        kernel("after", 400, 50, 8), launch(99, 8, tid_main),                # past the window
        kernel("stray", 310, 3, 9), launch(150, 9, tid_main),                # in no span
    ]
    got = {e["name"] + str(e["args"]["correlation"]): i for e, _, i in
           program_trace.charges(events, (0, 420), spans, (main, tid_main))}
    # the thread 99 has no span open: its launch goes to the main thread's
    assert got == {"gemm_a1": 1, "gemm_b2": 1, "ln3": 0, "gemm_a4": 2, "copy5": 3,
                   "late6": 0, "orphan7": program_trace.UNLAUNCHED, "after8": 0, "stray9": -1}
    by_index, by_name = program_trace.attribute(events, (0, 420), spans, (main, tid_main))
    assert by_index == pytest.approx({1: 40e-6, 2: 30e-6, 0: 33e-6, 3: 20e-6})
    assert by_name == pytest.approx({"kernels.K4": 70e-6, "encode_images.dispatch": 33e-6,
                                     "loader": 20e-6, program_trace.OUTSIDE: 3e-6,
                                     "unlaunched": 4e-6})
    # the driver's launches (cuDNN's, cuBLAS's) count as launches
    driven = [dict(e, cat="cuda_driver") if e["cat"] == "cuda_runtime" else e for e in events]
    assert [i for _, _, i in program_trace.charges(driven, (0, 420), spans, (main, tid_main))] \
        == list(got.values())


def test_the_clock_offset_comes_from_the_markers_launch():
    events = [kernel("at::cuda::spin_kernel(long)", 5000, 10, 9),
              launch(1004, 9, 1, dur=6.0)]
    offset, call = program_trace.clock_offset(events, (0.0, 10.0))
    # the launch [1004, 1010] lies inside the host's [0, 10] + offset: 1000 .. 1004
    assert offset == pytest.approx(1002.0) and call["tid"] == 1
    offset, call = program_trace.clock_offset(events[:1], (0.0, 10.0))
    assert offset == 5000 and call is None
