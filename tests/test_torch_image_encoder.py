"""The port's image encoder against the reference golden and the JAX encoder,
at the tiny vit_t config in fp32 on the CPU (ws=5 on an 8x8 grid: ragged pad
windows, 25 -> 32 dead slots, one global layer)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from samcarriestheburden_torch.config import sam_vit_t_config
from samcarriestheburden_torch.models import image_encoder as tie
from samcarriestheburden_torch.models.convert import sam_state_dict_from_torch
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_tpu.config import sam_vit_t_config as jax_vit_t_config
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import image_encoder as jie

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
CFG = sam_vit_t_config()


def _random_state_dict(seed):
    """Seeded random SAM weights, with rel-pos tables large enough that the
    rel-pos path moves the output."""
    sd = build_sam(CFG, device="cpu", seed=seed).state_dict()
    sd = {k: v.numpy().copy() for k, v in sd.items()}
    for k in sd:
        if k.endswith(("rel_pos_h", "rel_pos_w")):
            sd[k] *= 15.0
    return sd


def test_encoder_matches_golden():
    data = np.load(GOLDEN / "image_encoder.npz")
    sd = sam_state_dict_from_torch(
        {k[3:]: data[k] for k in data.files if k.startswith("sd/")})
    enc = tie.ImageEncoderViT(CFG.image_encoder)
    enc.load_state_dict(sd)
    out = enc(torch.from_numpy(data["x"]))
    np.testing.assert_allclose(out.numpy(), data["out"], atol=2e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "pallas_flat3d"])
def test_encoder_matches_jax(rng, fused):
    """The JAX encoder in fp32: its XLA path, and the flat-window path that
    runs K1/K3/K5/K7 (fused_mlp, fused_qkv, Pallas in interpret mode)."""
    sd = _random_state_dict(0)
    params = jconvert.sam_params_from_torch(sd, jax_vit_t_config())
    model = build_sam(CFG, device="cpu", state_dict=sam_state_dict_from_torch(sd))
    x = rng.standard_normal((2, 3, CFG.image_encoder.img_size,
                             CFG.image_encoder.img_size)).astype(np.float32)
    jcfg = jax_vit_t_config().image_encoder
    if fused:
        with pltpu.force_tpu_interpret_mode():
            ref = jie.apply(params["image_encoder"], jcfg, jnp.asarray(x),
                            fused_mlp=True, fused_qkv=True, scan_blocks=False)
    else:
        ref = jie.apply(params["image_encoder"], jcfg, jnp.asarray(x))
    ours = model.image_encoder(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4)


def test_window_partition_flat_matches_jax(rng):
    ws, b, h, w, c = 5, 2, 12, 9, 16                    # h, w not multiples of ws
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ref, ref_hw = jie.window_partition_flat(jnp.asarray(x), ws)
    ours, pad_hw = tie.window_partition_flat(torch.from_numpy(x), ws)
    assert pad_hw == ref_hw
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    back = tie.window_unpartition_flat(ours, ws, pad_hw, (h, w))
    np.testing.assert_array_equal(back.numpy(), x)


def test_pad_mask_marks_image_tokens_only():
    """1 on image tokens; 0 on the grid padding (keys, whose q/k/v become
    the qkv bias) and on the 8-alignment dead slots."""
    b, g, ws = 2, 8, 5
    mask = tie.pad_valid_flat(b, g, g, ws, torch.float32, "cpu")
    n = ws * ws
    ref = jie._pad_valid_mask(b, g, g, ws, jnp.float32)
    assert tuple(mask.shape) == (b * 4, 32, 1)
    np.testing.assert_array_equal(mask[:, :n].numpy(), np.asarray(ref).reshape(b * 4, n, 1))
    assert mask[:, n:].abs().sum() == 0
    assert mask.sum() == b * g * g


def test_forward_runs_the_plain_ops_on_cpu(rng):
    """The kernel wrappers and the plain versions give the same encoder on
    the CPU: the wrappers dispatch on the tensor's device alone."""
    model = build_sam(CFG, device="cpu", seed=3)
    x = torch.from_numpy(rng.standard_normal((1, 3, 128, 128)).astype(np.float32))
    a = model.image_encoder(x, ops=tie.KERNEL_OPS)
    b = model.image_encoder(x, ops=tie.PLAIN_OPS)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
