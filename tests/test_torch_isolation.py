"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import ast
import json
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import samcarriestheburden_torch
from samcarriestheburden_torch.config import sam_vit_t_config
from samcarriestheburden_torch.device import resolve_device
from samcarriestheburden_torch.models.sam import build_sam

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "samcarriestheburden_torch"
CHIP_SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "samcarriestheburden_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(samcarriestheburden_torch.__path__,
                                                        "samcarriestheburden_torch."))


def test_every_module_imports_without_jax():
    modules = _port_modules()
    assert "samcarriestheburden_torch.kernels.attention" in modules
    code = ("import sys\n"
            + "".join(f"sys.modules[{name!r}] = None\n" for name in FORBIDDEN)
            + "import importlib\n"
            + f"for name in {modules!r}:\n    importlib.import_module(name)\n"
            + "import chip_smoke\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_every_module_imports_without_h5py():
    """The card's machine has no h5py: the port imports it only where an h5
    file is opened (``data/h5io.py``), never with a module."""
    modules = _port_modules()
    for name in ("data.h5io", "engine.decoder_head", "engine.refinement", "kernels.ccl"):
        assert f"samcarriestheburden_torch.{name}" in modules
    code = ("import sys\nsys.modules['h5py'] = None\n"
            + "import importlib\n"
            + f"for name in {modules!r}:\n    importlib.import_module(name)\n"
            + "import chip_smoke\nchip_smoke.enhance_modules()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_sam(sam_vit_t_config(), seed=0)
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    """Away from the repo (or without a card) the smoke test exits non-zero
    and prints no result line."""
    shutil.copy(CHIP_SMOKE, tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
