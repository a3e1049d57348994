"""K8's plain version and the port's component selection against the JAX
package's ``ops/ccl.py`` (its XLA loop and its Pallas kernel in interpret
mode), on seeded maps built to stress the propagation: speckle with many
components, spirals and 1-pixel diagonal chains, run truncated and to the
fixpoint.  Labels, flags and kept masks must be equal (tolerance 0)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from samcarriestheburden_torch.kernels import ccl as kccl
from samcarriestheburden_torch.ops import ccl as tccl
from samcarriestheburden_tpu.ops import ccl as jccl

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

H, W = 24, 40
ROOT = Path(__file__).resolve().parents[1]


def speckle(seed: int, n: int = 3, p: float = 0.45) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random((n, H, W)) < p).astype(np.float32)


def spiral(h: int = H, w: int = W) -> np.ndarray:
    """A 1-pixel square spiral with one free pixel between its arms: its
    geodesic length is far beyond any small step cap."""
    m = np.zeros((h, w), np.float32)
    top, left, bottom, right = 0, 0, h - 1, w - 1
    while top <= bottom and left <= right:
        m[top, left:right + 1] = 1
        m[top:bottom + 1, right] = 1
        if bottom - top >= 2:
            m[bottom, left:right + 1] = 1
        if right - left >= 2 and bottom - top >= 4:
            m[top + 2:bottom + 1, left] = 1
            m[top + 2, left + 1] = 1               # on into the next ring
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
    return m


def diagonal_chains(h: int = H, w: int = W) -> np.ndarray:
    """1-pixel chains that connect only through corners (8-connectivity):
    two anti-parallel diagonals and a zigzag."""
    m = np.zeros((h, w), np.float32)
    for i in range(min(h, w)):
        m[i, i] = 1                                   # main diagonal
        m[i, w - 1 - i] = 1                           # anti-diagonal, crosses it
    for c in range(w):
        m[h - 1 - (c % 4 if c % 8 < 4 else 3 - c % 4), c] = 1   # zigzag near the bottom
    return m


def stress_maps() -> np.ndarray:
    return np.concatenate([speckle(0), spiral()[None], diagonal_chains()[None],
                           np.zeros((1, H, W), np.float32), np.ones((1, H, W), np.float32)])


def jax_per_map(maps: np.ndarray, cap: int):
    out = [jccl.connected_components(jnp.asarray(m), cap, return_converged=True) for m in maps]
    return np.stack([np.asarray(lab) for lab, _ in out]), np.array([bool(c) for _, c in out])


CAPS = [7, 37, H * W]


@pytest.mark.parametrize("cap", CAPS)
def test_plain_k8_matches_jax_xla_loop(cap):
    maps = stress_maps()
    labels, converged, steps = kccl.propagate_plain(torch.from_numpy(maps), cap)
    want_labels, want_conv = jax_per_map(maps, cap)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    np.testing.assert_array_equal(converged.numpy(), want_conv)
    assert labels.dtype == torch.int32
    # every map runs whole chunks of 16 until the cap, or past its fixpoint
    assert (steps.numpy() <= cap).all() and (steps.numpy()[~want_conv] == cap).all()
    if cap == H * W:
        assert want_conv.all()
    else:
        assert not want_conv[3]                       # the spiral stays truncated


@pytest.mark.parametrize("cap", CAPS)
def test_connected_components_matches_jax_pallas_interpret(cap):
    maps = stress_maps()
    labels, conv = tccl.connected_components(torch.from_numpy(maps), cap, return_converged=True)
    want, want_conv = jccl.connected_components_pallas(jnp.asarray(maps), cap,
                                                       return_converged=True, interpret=True)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want))
    assert bool(conv) == bool(want_conv)


def test_connected_components_keeps_leading_axes():
    maps = stress_maps()[:6].reshape(2, 3, H, W)
    labels = tccl.connected_components(torch.from_numpy(maps), 37)
    want = jccl.connected_components(jnp.asarray(maps), 37)
    assert labels.shape == (2, 3, H, W)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want))


def _propagate_4conn(mask, num_iterations, check_every=16):
    """A planted fault: the plain version with 4-connected steps."""
    fg = mask > 0.5
    h, w = mask.shape[-2:]
    labels = torch.arange(1, h * w + 1, dtype=torch.int32).view(h, w) * fg
    cur = labels.float()
    for _ in range(num_iterations):
        p = F.pad(cur, (1, 1, 1, 1))
        cross = torch.stack([cur, p[:, :-2, 1:-1], p[:, 2:, 1:-1], p[:, 1:-1, :-2],
                             p[:, 1:-1, 2:]]).amax(0)
        new = cross * fg
        if torch.equal(new, cur):
            break
        cur = new
    return cur.int(), torch.ones(mask.shape[0], dtype=torch.bool), None


def test_four_connected_mutant_is_caught(monkeypatch):
    """The comparisons above must see a 4-connected propagation."""
    maps = stress_maps()
    monkeypatch.setattr(kccl, "propagate_plain", _propagate_4conn)
    labels = tccl.connected_components(torch.from_numpy(maps), H * W)
    want_labels, _ = jax_per_map(maps, H * W)
    assert not np.array_equal(labels.numpy(), want_labels)
    assert not np.array_equal(labels.numpy()[4], want_labels[4])   # the diagonal chains


# ---------------------------------------------------------------------------
# remove_all_but_one_connected_component
# ---------------------------------------------------------------------------


def _probs(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) > 0.6) * rng.random(shape)).astype(np.float32)


def _both(prob: np.ndarray, selection: str, num_iter: int):
    got = tccl.remove_all_but_one_connected_component(torch.from_numpy(prob), selection,
                                                      num_iter).numpy()
    want = np.asarray(jccl.remove_all_but_one_connected_component(prob, selection, num_iter))
    return got, want


@pytest.mark.parametrize("selection", ["largest", "highest_probability"])
@pytest.mark.parametrize("shape", [(5, 40, 48), (2, 3, 40, 48)])
def test_selection_matches_jax(selection, shape):
    prob = _probs(3, shape)
    prob[(0,) * (len(shape) - 2)] = 0.0               # an empty class stays empty
    got, want = _both(prob, selection, max(shape[-2:]))
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got[(0,) * (len(shape) - 2)].any()


@pytest.mark.parametrize("selection", ["largest", "highest_probability"])
def test_selection_ties_break_to_smallest_label(selection):
    """JAX's tests/test_ccl.py tie case: two equal blobs, the top-left one
    (smaller label) wins under both selections."""
    h, w = 24, 32
    prob = np.zeros((2, h, w), np.float32)
    prob[0, 2:4, 2:4] = 0.7
    prob[0, 18:20, 24:26] = 0.7
    for c in range(2, 26, 4):
        prob[1, 10, c] = 0.6
    got, want = _both(prob, selection, h * w)
    expect = np.zeros_like(prob[0])
    expect[2:4, 2:4] = 0.7
    np.testing.assert_array_equal(got[0], expect)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("selection", ["largest", "highest_probability"])
def test_selection_beyond_256_components(selection):
    """400 specks and one blob: more components than the JAX top-k stage
    holds, so JAX takes its exact histogram branch; the port always does."""
    h, w = 96, 96
    prob = np.zeros((1, h, w), np.float32)
    prob[0, 2:10, 2:10] = 0.9
    for r in range(12, 92, 4):
        for c in range(12, 92, 4):
            prob[0, r, c] = 0.6
    got, want = _both(prob, selection, max(h, w))
    np.testing.assert_array_equal(got, want)
    assert got[0, 5, 5] > 0 and not got[0, 12:, 12:].any()


def test_selection_on_stress_maps_matches_jax():
    maps = stress_maps() * np.float32(0.75)
    got, want = _both(maps, "largest", max(H, W))
    np.testing.assert_array_equal(got, want)


def test_selection_rejects_bad_arguments():
    with pytest.raises(NotImplementedError):
        tccl.remove_all_but_one_connected_component(torch.zeros(1, 4, 4), "smallest", 4)
    with pytest.raises(ValueError):
        tccl.remove_all_but_one_connected_component(torch.zeros(4, 4), "largest", 4)


# ---------------------------------------------------------------------------
# the wrapper's contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw,size", [((384, 224), 4), ((48, 32), 1), ((512, 448), 8)])
def test_cluster_size(hw, size):
    assert kccl.cluster_size(*hw) == size


def test_cluster_size_refuses_maps_no_cluster_holds():
    with pytest.raises(ValueError, match="K8 takes maps"):
        kccl.cluster_size(2048, 2048)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel or raises (here: a meta
    tensor, which the kernel does not take)."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        kccl.propagate(torch.empty((2, H, W), device="meta"), 7)
    with pytest.raises(ValueError, match="check_every"):
        kccl.propagate(torch.zeros((1, H, W)), 7, check_every=0)


# ---------------------------------------------------------------------------
# the register kernel's geometry and temporal blocking
# ---------------------------------------------------------------------------


def _chip_smoke():
    """``chip_smoke.py`` (its model of the register kernel), loaded by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("hw,kernel,cluster,cols", [
    ((384, 224), "registers", 4, 7),     # the main path's maps
    ((48, 32), "registers", 1, 1),
    ((97, 33), "registers", 2, 2),
    ((768, 256), "registers", 8, 8),     # the largest map the register kernel holds
    ((769, 256), "shared", 8, 0),        # one row too tall
    ((384, 257), "shared", 4, 0),        # one column too wide
    ((512, 448), "shared", 8, 0),
    ((1024, 224), "shared", 8, 0),
    ((8, 28928), "shared", 8, 0),
])
def test_geometry(hw, kernel, cluster, cols):
    geo = kccl.geometry(*hw)
    assert (geo.kernel, geo.cluster, geo.cols_per_lane) == (kernel, cluster, cols)
    assert geo.halo >= geo.depth >= 1
    if kernel == "registers":
        band = -(-hw[0] // cluster)
        assert hw[1] <= 32 * cols and band <= kccl.REG_MAX_BAND
        assert cluster == 1 or band >= geo.halo       # a halo lies in one neighbour's band
        assert (geo.halo, geo.depth) == (kccl.REG_HALO, kccl.REG_DEPTH)
    else:
        assert geo.cluster == kccl.cluster_size(*hw) and (geo.halo, geo.depth) == (1, 1)


def test_geometry_refuses_maps_no_kernel_holds():
    with pytest.raises(ValueError, match="K8 takes maps"):
        kccl.geometry(2048, 2048)


@pytest.mark.parametrize("cap,check_every,groups", [
    (37, 16, [[16], [16], [5]]),
    (37, 48, [[16, 16, 5]]),
    (48, 48, [[16, 16, 16]]),
    (17, 16, [[16], [1]]),               # a 1-step last chunk
    (100, 40, [[16, 16, 8], [16, 16, 8], [16, 4]]),
    (0, 16, []),
])
def test_barrier_groups(cap, check_every, groups):
    got = kccl.barrier_groups(cap, check_every)
    assert got == groups
    assert [sum(c) for c in got] == [min(check_every, cap - i)
                                     for i in range(0, cap, check_every)]
    assert all(1 <= g <= kccl.REG_DEPTH <= kccl.REG_HALO for c in got for g in c)


# a scaled-down geometry of the register kernel: 4 bands of 10 rows with
# halos of 4 rows, 4 steps per barrier, on maps of (40, 48)
SMALL_GEO = kccl.Geometry("registers", 4, 2, 4, 4)
SMALL_HW = (40, 48)


def _small_maps():
    """Speckle, a spiral, diagonal chains, an empty map and a line along row
    15, which lies in no halo: its labels travel 47 steps without touching
    a halo row."""
    h, w = SMALL_HW
    rng = np.random.default_rng(7)
    line = np.zeros((1, h, w), np.float32)
    line[0, 15] = 1
    return np.concatenate([(rng.random((2, h, w)) < 0.45).astype(np.float32),
                           spiral(h, w)[None], diagonal_chains(h, w)[None],
                           np.zeros((1, h, w), np.float32), line])


@pytest.mark.parametrize("cap", [7, 37, SMALL_HW[0] * SMALL_HW[1]])
@pytest.mark.parametrize("check_every", [16, 5, 48])
def test_blocked_model_matches_plain(cap, check_every):
    """The register kernel's blocking (``chip_smoke.k8_blocked``: bands,
    halos copied at each barrier, groups that end at chunk ends, the changed
    bit over own rows) gives the plain version's labels, flags and steps."""
    maps = torch.from_numpy(_small_maps())
    got = _chip_smoke().k8_blocked(torch, kccl, maps, cap, check_every, SMALL_GEO)
    want = kccl.propagate_plain(maps, cap, check_every)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_blocked_model_faults_are_caught():
    """Each planted fault of the blocking changes at least 4 labels (the
    chip check's FAULT_MARGIN), at the scaled-down geometry."""
    cs = _chip_smoke()
    maps = torch.from_numpy(_small_maps())
    full = maps[0].numel()
    truncated = kccl.propagate_plain(maps, cs.K8_TRUNCATED)[0]
    converged = kccl.propagate_plain(maps, full)[0]
    faults = cs.k8_blocked_faults(torch, kccl, maps, SMALL_GEO, truncated, converged)
    assert len(faults) == 3
    for what, (labels, want) in faults.items():
        assert int((labels != want).sum()) >= cs.FAULT_MARGIN, what
    # taken over the halo as well as the own rows, the changed bit changes nothing
    both = cs.k8_blocked(torch, kccl, maps, full, 16, SMALL_GEO)
    assert torch.equal(both[0], converged)
