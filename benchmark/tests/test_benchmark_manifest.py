"""The manifest, and every file a name in it leads to."""

import json
import re

import pytest

from harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
MAN = core.manifest()
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not set(text) & {"\n", "\r", "\t"}


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MAN[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in MAN[key]]
        assert len(got) == len(set(got)), key
    assert all(UNIT.match(m["unit"]) for m in MAN["end_to_end"] + MAN["per_layer"])
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024
    for key, keys in KEYS.items():
        for entry in MAN[key]:
            extra = {"workloads"} if key in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, (key, entry["name"])
    assert 1 <= len(MAN["command"]) <= 32 and all(one_line(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert all(m["better"] in ("lower", "higher") for m in MAN["end_to_end"] + MAN["per_layer"])
    assert all(one_line(m["layer"]) for m in MAN["per_layer"])
    # A full check with 24 cells has to fit its 43,200 seconds.
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs_files_and_cuts():
    for c in MAN["configs"]:
        assert set(c) == KEYS["configs"]
        assert one_line(c["why"]) and one_line(c["source"])
        cfg = core.load_json(core.ROOT / c["file"])
        assert c["file"].startswith("benchmark/") and cfg["reduced"] == c["reduced"] == []
        assert "source" in cfg and "assumed" in cfg
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_every_cell_is_found_by_name(name):
    w, cfg, config, traffic = core.cell(MAN, name)
    assert set(w) == KEYS["workloads"]
    assert w["chips"] == 1 and one_line(w["why"])
    drv = core.driver_for(traffic)
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(drv, fn))
    reported = [m["name"] for m in MAN["end_to_end"]
                if "workloads" not in m or name in m["workloads"]]
    assert "setup_s" in reported and traffic["rate_metric"] in reported and len(reported) == 2
    layer = core.layer_metrics(MAN, w)
    assert layer and all(m["moves"] in reported for m in layer)
    assert set(traffic["limits"]) and all(v > 0 for v in traffic["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_every_layer_metric_has_its_reader(metric):
    m = {x["name"]: x for x in MAN["per_layer"]}[metric]
    assert callable(core.load_module(core.BENCH_DIR / "metrics" / f"{metric}.py").read)
    assert m["source"] == "device_trace" and m["better"] in ("higher", "lower")
    ends = {e["name"]: e for e in MAN["end_to_end"]}
    for w in m["workloads"]:
        assert w in ends[m["moves"]].get("workloads", [w])


def test_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in MAN["end_to_end"]}["setup_s"] == 0.25
