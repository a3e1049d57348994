"""Whole runs of every cell on the CPU at a tiny size: the contract's last
line, the reference against the port, the lower-precision controls and the
planted faults, and what the run loads."""

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, tiny
from harness import core
from harness.faults import planted

MAN = core.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
SEED = 2 ** 31 + 4099


def driver(name):
    return core.driver_for(core.cell(MAN, name)[3])


def run(name, seed=SEED, trace=False, fault=None):
    with planted(driver(name), fault):
        return core.execute(name, seed, 0.5, trace, "cpu", time.perf_counter(), override=tiny)


@pytest.mark.parametrize("name", CELLS)
def test_smoke_run_prints_the_contract_line(name, capsys):
    result = run(name)
    core.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    w = {x["name"]: x for x in MAN["workloads"]}[name]
    traffic = core.cell(MAN, name)[3]
    assert set(line["metrics"]) == {traffic["rate_metric"], "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["count"] == w["chips"]
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    result = run(name, seed=SEED + 1)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_control_fails(name):
    """The cell's control (its driver's ``CONTROL``: the reference in the
    program's place at the precision below the configuration's, or the
    program's own lower-precision path) fails at least one number."""
    readings = core.control(name, SEED, "cpu", override=tiny, seconds=0.5)
    checks = core.judge(readings, core.cell(MAN, name)[3]["limits"])
    assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("name,fault", [(name, fault) for name in CELLS
                                        for fault in driver(name).FAULTS])
def test_planted_fault_is_caught(name, fault):
    result = run(name, fault=fault)
    assert result["correct"] is False, result["checks"]


def test_cli_refuses_without_a_card():
    """Without CUDA the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, f"{BENCH}/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time; sys.path[:0] = [%r, %r]; import conftest; "
            "from harness import core; "
            "core.execute(%r, 7, 0.3, False, 'cpu', time.perf_counter(), override=conftest.tiny); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % (
        f"{BENCH}/tests", BENCH, CELLS[0])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=BENCH)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "samcarriestheburden_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "samcarriestheburden_tpu", "bench"}


@pytest.mark.parametrize("fault", ["half_batch_late", "state_unchanged_late"])
def test_a_fault_after_the_first_epoch_fails_only_the_windows_numbers(fault):
    """Epoch 0, which set-up runs, is clean; the window's steps are not, and
    only the numbers of the window's last epoch see it."""
    result = run("unet_grazpedwri.train", fault=fault)
    checks = {k: v["value"] <= v["limit"] for k, v in result["checks"].items()}
    assert all(ok for k, ok in checks.items() if not k.startswith("window_")), checks
    assert not all(ok for k, ok in checks.items() if k.startswith("window_")), checks
