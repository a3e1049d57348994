"""The manifest, and every file a name in it leads to, held to the contract:
the checks take a manifest and the checkout it reads its files from, so
that hand-made manifests show what a new configuration may bring and what
it may not."""

import copy
import json
import re
import shutil
from pathlib import Path

import pytest

from harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
#: keys that name a width, which ``reduced`` may never cut
WIDTH = re.compile(r"(_dim|_rank|_channels|_chans|_ratio|_width|_mul|intermediate_size|"
                   r"hidden_size|head_size|state_size|experts_per_tok|expansion)$")
MAN = core.manifest()
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
#: what a cell's driver has to bring, beside ``control`` where its
#: ``CONTROL`` runs in the program's place
HOOKS = ("setup", "window", "release", "check", "tiny")


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not set(text) & {"\n", "\r", "\t"}


def check_form(man, accepted_four=0):
    """The keys, names, units, texts and sizes of the whole manifest; at
    most a quarter of its cells (at least one, or ``accepted_four``, as many
    as the accepted benchmark has) on four chips."""
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in man[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in man[key]]
        assert len(got) == len(set(got)), key
    assert all(UNIT.match(m["unit"]) for m in man["end_to_end"] + man["per_layer"])
    assert 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) < 64 * 1024
    for key, keys in KEYS.items():
        for entry in man[key]:
            extra = {"workloads"} if key in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, (key, entry["name"])
    assert 1 <= len(man["command"]) <= 32 and all(one_line(w) for w in man["command"])
    assert 1 <= len(man["paths"]) <= 16 and all(PATH.match(p) for p in man["paths"])
    assert all(m["better"] in ("lower", "higher") for m in man["end_to_end"] + man["per_layer"])
    assert all(one_line(m["layer"]) for m in man["per_layer"])
    # A full check with 24 cells has to fit its 43,200 seconds.
    assert (2 + 14 * 24) * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(man["workloads"]) <= 24 and 1 <= len(man["configs"]) <= 24
    four = [w["name"] for w in man["workloads"] if w["chips"] == 4]
    allowed = max(1, len(man["workloads"]) // 4, accepted_four)
    assert len(four) <= allowed, \
        f"{len(four)} of {len(man['workloads'])} cells ask for 4 chips ({four}); at most {allowed}"


def check_configs(man, root=core.ROOT):
    """Each configuration's file and its cuts: ``reduced`` lists, in the
    manifest and in the file alike, the keys cut from the source, never a
    width."""
    for c in man["configs"]:
        assert set(c) == KEYS["configs"]
        assert one_line(c["why"]) and one_line(c["source"])
        assert c["file"].startswith("benchmark/")
        cfg = core.load_json(root / c["file"])
        cut = c["reduced"]
        assert isinstance(cut, list) and len(cut) <= 16, c["name"]
        assert all(one_line(k) and NAME.match(k) for k in cut), (c["name"], cut)
        widths = [k for k in cut if WIDTH.search(k)]
        assert not widths, f"{c['name']}: reduced names widths {widths}"
        assert cfg["reduced"] == cut, \
            f"{c['file']}: reduced {cfg['reduced']} against the manifest's {cut}"
        assert "source" in cfg and "assumed" in cfg
        assert any(w["config"] == c["name"] for w in man["workloads"])


def check_cell(man, name, root=core.ROOT):
    """A cell is found by its names, its driver brings every hook the
    harness and the tests call, and it reports ``setup_s``, its rate and
    per-layer metrics."""
    w, cfg, config, traffic = core.cell(man, name, root)
    assert set(w) == KEYS["workloads"]
    assert w["chips"] in (1, 4) and one_line(w["why"])
    path = core.driver_path(traffic, root)
    where = path.relative_to(root)
    drv = core.driver_for(traffic, root)
    for fn in HOOKS:
        assert callable(getattr(drv, fn, None)), f"{where} lacks {fn}"
    control = getattr(drv, "CONTROL", None)
    assert isinstance(control, tuple) and len(control) == 2 and \
        control[0] in ("control", "program") and isinstance(control[1], dict), \
        f"{where} lacks CONTROL = (\"control\" | \"program\", {{changes}})"
    if control[0] == "control":
        assert callable(getattr(drv, "control", None)), f"{where} lacks control"
    faults = getattr(drv, "FAULTS", None)
    assert isinstance(faults, dict) and faults and all(map(callable, faults.values())), \
        f"{where} lacks FAULTS, the faults its cell can have"
    reported = [m["name"] for m in man["end_to_end"]
                if "workloads" not in m or name in m["workloads"]]
    assert "setup_s" in reported and traffic["rate_metric"] in reported and len(reported) == 2
    layer = core.layer_metrics(man, w)
    assert layer and all(m["moves"] in reported for m in layer)
    assert set(traffic["limits"]) and all(v > 0 for v in traffic["limits"].values())


def check_layer_metric(man, metric, root=core.ROOT):
    m = {x["name"]: x for x in man["per_layer"]}[metric]
    path = root / core.BENCH_DIR.name / "metrics" / f"{metric}.py"
    assert callable(core.load_module(path).read)
    assert m["source"] == "device_trace" and m["better"] in ("higher", "lower")
    ends = {e["name"]: e for e in man["end_to_end"]}
    for w in m["workloads"]:
        assert w in ends[m["moves"]].get("workloads", [w])


def check_bounds(man):
    for m in man["end_to_end"]:
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in man["end_to_end"]}["setup_s"] == 0.25


def admit(man, root=core.ROOT, accepted_four=0):
    """Every check above on ``man``, its files read under ``root``; an
    AssertionError names what the contract refuses."""
    check_form(man, accepted_four)
    check_configs(man, root)
    for w in man["workloads"]:
        check_cell(man, w["name"], root)
    for m in man["per_layer"]:
        check_layer_metric(man, m["name"], root)
    check_bounds(man)


def test_manifest_keys_and_names():
    check_form(MAN)


def test_configs_files_and_cuts():
    check_configs(MAN)


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_every_cell_is_found_by_name(name):
    check_cell(MAN, name)


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_every_layer_metric_has_its_reader(metric):
    check_layer_metric(MAN, metric)


def test_bounds():
    check_bounds(MAN)


# Hand-made manifests, on a copy of the benchmark's files.

@pytest.fixture
def checkout(tmp_path):
    shutil.copytree(core.BENCH_DIR, tmp_path / core.BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path, copy.deepcopy(MAN)


def add_cut_cell(root: Path, man: dict, name="handmade_cut") -> str:
    """A configuration cut in depth, with a cell of the int8 precompute mix
    that reports ``images_per_s`` and the device's idle share."""
    cfg = core.load_json(core.ROOT / "benchmark/configs/sam_vit_h.json")
    cfg.update(encoder_depth=16, encoder_global_attn_indexes=[3, 7, 11, 15],
               reduced=["encoder_depth", "encoder_global_attn_indexes"])
    (root / f"benchmark/configs/{name}.json").write_text(json.dumps(cfg))
    man["configs"].append({"name": name, "source": man["configs"][0]["source"],
                           "file": f"benchmark/configs/{name}.json", "reduced": cfg["reduced"],
                           "why": "SAM ViT-H at half depth"})
    cell = f"{name}.precompute_int8"
    man["workloads"].append({"name": cell, "config": name, "traffic": "precompute_int8",
                             "chips": 1, "why": "the int8 precompute at half depth"})
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("images_per_s", "idle_share.precompute"):
            m["workloads"].append(cell)
    return cell


def test_a_cut_configuration_is_admitted(checkout):
    root, man = checkout
    add_cut_cell(root, man)
    admit(man, root)
    # the file's cuts and the manifest's have to agree
    man["configs"][-1]["reduced"] = ["encoder_depth"]
    with pytest.raises(AssertionError, match="reduced"):
        admit(man, root)


def test_a_second_four_chip_cell_of_four_is_refused():
    man = copy.deepcopy(MAN)
    man["workloads"] = cells = [{"name": f"handmade.t{i}", "config": "handmade",
                                 "traffic": f"t{i}", "chips": 1, "why": "a hand-made cell"}
                                for i in range(4)]
    cells[0]["chips"] = 4
    check_form(man)
    cells[1]["chips"] = 4
    with pytest.raises(AssertionError, match="2 of 4 cells ask for 4 chips"):
        check_form(man)
    check_form(man, accepted_four=2)


def test_a_driver_without_tiny_is_refused(checkout):
    root, man = checkout
    src = (core.BENCH_DIR / "drivers/precompute.py").read_text()
    (root / "benchmark/drivers/handmade_notiny.py").write_text(
        src.replace("def tiny(", "def _not_tiny("))
    mix = core.load_json(core.BENCH_DIR / "workloads/precompute_int8.json")
    (root / "benchmark/workloads/handmade_notiny.json").write_text(
        json.dumps({**mix, "driver": "handmade_notiny"}))
    cell = "sam_vit_h.handmade_notiny"
    man["workloads"].append({"name": cell, "config": "sam_vit_h", "traffic": "handmade_notiny",
                             "chips": 1, "why": "a driver without its CPU shrink"})
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("images_per_s", "idle_share.precompute"):
            m["workloads"].append(cell)
    with pytest.raises(AssertionError, match=r"benchmark/drivers/handmade_notiny\.py lacks tiny"):
        admit(man, root)
