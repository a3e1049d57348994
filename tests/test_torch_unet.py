"""The port's U-Net (``models/unet.py``) and its weight loaders against the
reference golden and the JAX package, on the CPU in fp32."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samcarriestheburden_torch.config import UNetConfig as TorchUNetConfig
from samcarriestheburden_torch.models import convert as tconvert
from samcarriestheburden_torch.models.unet import UNet, build_unet, unet_probabilities
from samcarriestheburden_tpu.config import GRAZ_IMG_MEAN, GRAZ_IMG_STD, UNetConfig
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import unet as junet

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
#: the port against the reference golden and JAX ``unet.apply``, fp32 logits:
#: the same convolutions in another order of summation
LOGIT_TOL = 1e-4

_jax_apply = jax.jit(junet.apply, static_argnums=1)


def test_unet_matches_the_reference_golden():
    """Full width (base 64, 17 classes): the reference state dict loads with
    ``load_state_dict`` under its own names and gives the golden logits."""
    data = np.load(GOLDEN / "unet.npz")
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    model = UNet()
    model.load_state_dict(sd)                   # strict: every name matches
    with torch.no_grad():
        y = model(torch.from_numpy(data["x"]))
    np.testing.assert_allclose(y.numpy(), data["y"], atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("bilinear", [False, True], ids=["transposed", "bilinear"])
@pytest.mark.parametrize("base,hw", [(4, (37, 29)), (8, (48, 40))], ids=["b4-odd", "b8"])
def test_unet_matches_jax_apply(bilinear, base, hw):
    """Seeded weights carried to the JAX layout by ``unet_params_from_torch``
    and back by ``unet_state_dict_from_jax`` (the transposed convs' flip
    applied and undone) to the same tensors, and an odd input size that
    exercises pad-to-match."""
    jcfg = UNetConfig(base_channels=base, n_last_channel=base, bilinear=bilinear)
    tcfg = TorchUNetConfig(base_channels=base, n_last_channel=base, bilinear=bilinear)
    model = build_unet(tcfg, device="cpu", seed=base)
    params = tconvert.unet_params_from_torch(model.state_dict(), tcfg)
    x = np.random.default_rng(base).standard_normal((2, 1, *hw)).astype(np.float32)
    want = np.asarray(_jax_apply(params, jcfg, x))
    back = UNet(tcfg)
    back.load_state_dict(tconvert.unet_state_dict_from_jax(params, tcfg))
    for (name, a), b in zip(model.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), name
    with torch.no_grad():
        got = back(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 17, *hw)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


def test_load_reference_unet_matches_jax(tmp_path):
    """A reference LoadableModel bundle (``{'config', 'model_state'}``) loads
    in both packages to the same config and weights."""
    data = np.load(GOLDEN / "unet.npz")
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    path = tmp_path / "unet.pth"
    torch.save({"config": {"n_channels": 1, "n_classes": 17, "bilinear": False},
                "model_state": sd}, path)
    cfg, got = tconvert.load_reference_unet(path)
    jcfg, jparams = jconvert.load_reference_unet(path)
    assert cfg == TorchUNetConfig() and jcfg == UNetConfig()
    assert sorted(got) == sorted(sd)
    want = tconvert.unet_state_dict_from_jax(jparams, cfg)
    for k in sd:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    torch.save({"not": "a bundle"}, tmp_path / "x.pth")
    with pytest.raises(ValueError, match="LoadableModel"):
        tconvert.load_reference_unet(tmp_path / "x.pth")


def test_build_unet_and_probabilities():
    """Seeded weights are reproducible; ``unet_probabilities`` is the JAX
    CLIs' sigmoid of the U-Net on the normalised uint8 image."""
    cfg = TorchUNetConfig(base_channels=4, n_last_channel=4)
    a, b = (build_unet(cfg, device="cpu", seed=1) for _ in range(2))
    for (n, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(p, q), n
    assert not a.training and a.device.type == "cpu"
    with pytest.raises(ValueError, match="exactly one"):
        build_unet(cfg, device="cpu")
    params = tconvert.unet_params_from_torch(a.state_dict(), cfg)
    imgs = np.random.default_rng(0).integers(0, 256, (2, 32, 24)).astype(np.uint8)
    x = (imgs[:, None].astype(np.float32) / 255.0 - GRAZ_IMG_MEAN) / GRAZ_IMG_STD
    jcfg = UNetConfig(base_channels=4, n_last_channel=4)
    want = np.asarray(jax.nn.sigmoid(_jax_apply(params, jcfg, jnp.asarray(x))))
    got = unet_probabilities(a, torch.from_numpy(imgs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
