"""The K8 A/B tool (``samcarriestheburden_torch/tools/ab_ccl.py``) on the CPU.

The tool's kernel runs only on the card; here its input builder, its digest
and its summary are held at a small size: the inputs are the same for the
same seeds and are the enhance path's own (``chip_smoke.py``'s
probabilities, the cap ``remove_all_but_one_connected_component`` gives
K8), every case runs through ``kernels/ccl.py:propagate`` (its plain
version for a CPU tensor) to the same digest twice, and a one-label change
changes the digest.
"""

import numpy as np
import pytest
import torch

from samcarriestheburden_torch.kernels import ccl as kccl
from samcarriestheburden_torch.ops import ccl as tccl
from samcarriestheburden_torch.tools import ab_ccl

torch.set_num_threads(1)

SMALL = dict(images=1, grid=(24, 40), other=((20, 300),))


def test_the_inputs_are_the_seeds():
    a, b = ab_ccl.inputs("cpu", **SMALL), ab_ccl.inputs("cpu", **SMALL)
    assert list(a) == list(b)
    assert list(a) == ["main path 17x24x40"] + [
        f"stressed 24x40 cap {c} every {e}" for c, e in ((37, 16), (43, 16), (960, 16),
                                                          (37, 48), (960, 48))] + [
        "stressed 20x300 cap 37 every 16", "stressed 20x300 cap 6000 every 16"]
    for k in a:
        assert torch.equal(a[k][0], b[k][0]) and a[k][1:] == b[k][1:], k
        assert a[k][0].dtype == torch.float32 and a[k][0].is_contiguous()
    assert a["stressed 20x300 cap 37 every 16"][0].shape == (8, 20, 300)


def test_the_main_path_input_is_the_enhance_paths():
    """The 17 maps are ``chip_smoke.py``'s probabilities for the enhance
    path, and the cap is the one the selection gives K8."""
    mask, cap, every = ab_ccl.inputs("cpu", **SMALL)["main path 17x24x40"]
    probs = ab_ccl._smoke().enhance_probs(np, np.random.default_rng(ab_ccl.PROBS_SEED), 1,
                                          ab_ccl.CLASSES, (24, 40))
    assert torch.equal(mask, torch.from_numpy(probs.reshape(-1, 24, 40)))
    assert (cap, every) == (24 * 40, 16)
    seen = []
    propagate = kccl.propagate

    def record(m, n, check_every=16):
        seen.append((m, n, check_every))
        return propagate(m, n, check_every)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kccl, "propagate", record)
        tccl.remove_all_but_one_connected_component(torch.from_numpy(probs[0]),
                                                    "highest_probability", max(24, 40))
    assert torch.equal(seen[0][0], mask) and seen[0][1:] == (cap, every)


def test_every_case_gives_the_same_digest_twice():
    for name, (mask, cap, every) in ab_ccl.inputs("cpu", **SMALL).items():
        one, two = kccl.propagate(mask, cap, every), kccl.propagate(mask, cap, every)
        assert ab_ccl.digest(one[0]) == ab_ccl.digest(two[0]), name
        assert torch.equal(one[2], two[2]) and torch.equal(one[1], two[1])
        if "cap 37" in name:
            assert (one[2] <= 37).all() and not one[1].all()   # the spiral stays truncated


def test_the_digest_sees_one_label():
    labels = kccl.propagate(*ab_ccl.inputs("cpu", **SMALL)["main path 17x24x40"])[0]
    other = labels.clone()
    other.view(-1)[int(labels.argmax())] -= 1
    assert ab_ccl.digest(labels) == int(labels.long().sum())
    assert ab_ccl.digest(other) != ab_ccl.digest(labels)


def test_the_summary_compares_the_turns(capsys):
    row = {"ms": 1.0, "digest": 5, "steps": 80, "converged": 2, "max_diff": None}
    same = [("p", {"x": row}), ("c", {"x": dict(row, max_diff=0)})]
    ab_ccl.summary(same)
    assert "x: ms [1.0000, 1.0000] digests, steps and flags equal max diff 0" in \
        capsys.readouterr().out
    ab_ccl.summary(same + [("c", {"x": dict(row, steps=96, max_diff=0)})])
    assert "DIFFER" in capsys.readouterr().out


def test_the_tool_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_ccl.run(".", ".")
