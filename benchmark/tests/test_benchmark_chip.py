"""The controls and the program at the cells' own sizes, on the card only
(``-m chip``); ``calibrate.py`` reads the same on a dozen seeds."""

import time

import pytest

from harness import core

CELLS = [w["name"] for w in core.manifest()["workloads"]]
CONTROLS = {"sam_vit_h.precompute_int8": ("control", {}),
            "sam_vit_h.refine": ("control", {"decoder_dtype": "bfloat16"}),
            "unet_grazpedwri.train": ("program", {"compute_dtype": "bfloat16"})}


def _checks(name, device, seed, mode, changes):
    def override(config, traffic):
        for k, v in changes.items():
            (config if k in config else traffic)[k] = v
    if mode == "program":
        res = core.execute(name, seed, 3.0, False, device, time.perf_counter(),
                           override=override)
        return [core.Check(k, v["value"], v["limit"]) for k, v in res["checks"].items()]
    _, _, config, traffic = core.cell(core.manifest(), name)
    override(config, traffic)
    drv = core.driver_for(traffic)
    ctx = core.Context(seed=seed, device=device, config=config, traffic=traffic,
                       spans=core.Spans(), workload=name)
    return core.judge(drv.control(drv.setup(ctx), ctx), traffic["limits"])


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct_at_the_cells_size(name, card):
    assert all(c.ok for c in _checks(name, card, 2 ** 31 + 77, "program", {}))


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    mode, changes = CONTROLS[name]
    assert not all(c.ok for c in _checks(name, card, 2 ** 31 + 78, mode, changes))
