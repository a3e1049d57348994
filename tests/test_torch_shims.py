"""The port's reference-layout shims (``samcarriestheburden_torch/utils/``)
and ``version``: every name each JAX shim module exports exists in the
port's module of the same name, as an object of the port."""

import importlib
import inspect

import pytest

import samcarriestheburden_torch
from samcarriestheburden_torch import version as tversion
from samcarriestheburden_tpu import version as jversion

SHIMS = ("cvat_parser", "dice_coefficient", "random_walk", "seg_refinement",
         "segmentation_preprocessing")


def _public(module):
    return sorted(n for n, v in vars(module).items()
                  if not n.startswith("_") and not inspect.ismodule(v))


@pytest.mark.parametrize("shim", SHIMS)
def test_every_jax_shim_name_is_a_port_object(shim):
    jmod = importlib.import_module(f"samcarriestheburden_tpu.utils.{shim}")
    tmod = importlib.import_module(f"samcarriestheburden_torch.utils.{shim}")
    names = _public(jmod)
    assert names and names == _public(tmod)
    for name in names:
        obj = getattr(tmod, name)
        assert obj.__module__.startswith("samcarriestheburden_torch."), (name, obj.__module__)
        assert obj.__name__ == getattr(jmod, name).__name__


def test_the_reference_spellings_and_the_version():
    from samcarriestheburden_torch.engine.refinement import SamSegRefiner
    from samcarriestheburden_torch.utils.seg_refinement import SAMSegRefiner

    assert SAMSegRefiner is SamSegRefiner
    assert importlib.import_module("samcarriestheburden_torch.utils").__doc__
    assert tversion.__version__ == jversion.__version__
    assert samcarriestheburden_torch.__name__ == "samcarriestheburden_torch"
