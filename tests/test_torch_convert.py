"""Weights carried from the JAX package to the port (models/convert.py)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samcarriestheburden_torch.config import sam_vit_t_config
from samcarriestheburden_torch.models import convert
from samcarriestheburden_torch.models.convert import (sam_state_dict_from_jax,
                                                      sam_state_dict_from_torch)
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_tpu.config import sam_vit_t_config as jax_vit_t_config
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import image_encoder as jie
from samcarriestheburden_tpu.models import mask_decoder as jmd
from samcarriestheburden_tpu.models import sam as jsam
from samcarriestheburden_tpu.models.common import conv2d_transpose

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
CFG = sam_vit_t_config()
JCFG = jax_vit_t_config()


@pytest.fixture(scope="module")
def jax_params():
    """``sam.init`` params, with the zero-initialised rel-pos tables and
    abs-pos embedding made nonzero so their mapping counts."""
    params = jax.jit(jsam.init, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1)
    ie = params["image_encoder"]
    ie["pos_embed"] = 0.1 * rng.standard_normal(ie["pos_embed"].shape).astype(np.float32)
    for blk in ie["blocks"]:
        for name in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][name] = 0.3 * rng.standard_normal(
                blk["attn"][name].shape).astype(np.float32)
    return params


def test_jax_init_params_give_jax_outputs(rng, jax_params):
    model = build_sam(CFG, device="cpu", state_dict=sam_state_dict_from_jax(jax_params, CFG))

    x = rng.standard_normal((1, 3, 128, 128)).astype(np.float32)
    ref = jie.apply(jax_params["image_encoder"], JCFG.image_encoder, jnp.asarray(x))
    ours = model.image_encoder(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4)

    g = CFG.prompt_encoder.image_embedding_size
    emb = rng.standard_normal((2, 16, *g)).astype(np.float32)
    pe = rng.standard_normal((1, 16, *g)).astype(np.float32)
    sparse = rng.standard_normal((2, 3, 16)).astype(np.float32)
    dense = rng.standard_normal((2, 16, *g)).astype(np.float32)
    ref_m, ref_i = jmd.apply(jax_params["mask_decoder"], JCFG.mask_decoder, emb, pe,
                             sparse, dense, True)
    with torch.no_grad():
        masks, iou = model.mask_decoder(*(torch.from_numpy(a) for a in (emb, pe, sparse, dense)),
                                        multimask_output=True)
    np.testing.assert_allclose(masks.numpy(), np.asarray(ref_m), atol=1e-5)
    np.testing.assert_allclose(iou.numpy(), np.asarray(ref_i), atol=2e-5)


def test_reference_state_dict_round_trips_through_jax_layout():
    """torch names -> JAX pytree (the JAX package's loader) -> back: every
    tensor returns exactly, the stacked hypernetwork MLPs and the flipped
    transposed-conv kernels included."""
    data = np.load(GOLDEN / "sam_e2e.npz")
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd/")}
    back = sam_state_dict_from_jax(jconvert.sam_params_from_torch(sd, JCFG), CFG)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    build_sam(CFG, device="cpu", state_dict=sam_state_dict_from_torch(sd))


def test_transposed_conv_is_unflipped(rng):
    """The JAX storage of a ConvTranspose2d kernel is spatially flipped for
    lax.conv_transpose; torch's conv_transpose2d gives the JAX output only
    with the un-flipped kernel the port's loader makes."""
    up = torch.nn.ConvTranspose2d(6, 4, kernel_size=2, stride=2)
    p = jconvert._conv_t({f"t.{k}": v.detach().numpy() for k, v in up.state_dict().items()},
                         "t")
    x = rng.standard_normal((1, 5, 7, 6)).astype(np.float32)      # NHWC
    ref = np.asarray(conv2d_transpose(p, jnp.asarray(x), (2, 2)))

    sd = {}
    convert._conv_t(sd, "t", p)
    w, b = sd["t.weight"], sd["t.bias"]
    assert not torch.equal(w, w.flip(2, 3))
    with torch.no_grad():
        ours = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), w, b, stride=2)
        flipped = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), w.flip(2, 3), b, stride=2)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5)
    assert np.abs(flipped.permute(0, 2, 3, 1).numpy() - ref).max() > 1e-3


def test_reference_checkpoint_file_loads(tmp_path):
    """A reference ``.pth`` (torch.save of the state dict) loads into the port."""
    data = np.load(GOLDEN / "sam_e2e.npz")
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    torch.save(sd, tmp_path / "sam_vit_t.pth")
    loaded = convert.load_reference_checkpoint(tmp_path / "sam_vit_t.pth")
    assert set(loaded) == set(sd)
    model = build_sam(CFG, device="cpu", state_dict=loaded)
    torch.testing.assert_close(model.state_dict()["mask_decoder.iou_token.weight"],
                               sd["mask_decoder.iou_token.weight"], rtol=0, atol=0)
