"""End-to-end accuracy gate for the port's int8 serving mode: the counterpart
of the JAX package's ``tests/test_quantize.py::test_int8_serving_mask_agreement_vit_b``.

Weights made as the JAX gate makes its own (an initialisation perturbed by
0.03 N(0, 1), so that quantization is not exact; here the port's seeded
``build_sam``, since JAX's eager ``sam.init`` and perturbation take ~26 s on
the CPU), carried across to the JAX package with its
``sam_params_from_torch``; the same ViT-B geometry at a 448-pixel input,
encoded by the port's fp32, bf16
and int8 paths (on the CPU: the plain versions of the kernels, K2, K4 and
K7-int8 among them, over weights prequantized once), then decoded to
thresholded masks through the port's prompt encoder and mask decoder with
the same six box prompts.  The thresholds are the JAX gate's: every int8
mask's IoU against fp32 above 0.97, the IoU head's drift below 0.02, and
int8 no more than 0.02 worse than bf16.  The port's fp32 features are held
against JAX's, to show that the weights match."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from samcarriestheburden_torch.config import sam_vit_b_config as torch_vit_b_config
from samcarriestheburden_torch.models.image_encoder import default_ops
from samcarriestheburden_torch.models.quantize import prequantize_sam
from samcarriestheburden_torch.models.sam import build_sam
from samcarriestheburden_tpu.config import sam_vit_b_config
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import image_encoder as jimage_encoder

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

#: the JAX gate's thresholds (tests/test_quantize.py:113-116)
INT8_IOU_MIN = 0.97
INT8_QUALITY_DRIFT_MAX = 0.02
INT8_BELOW_BF16_MAX = 0.02
#: the port's fp32 features against JAX's at this depth and scale
FEATURE_TOL = 1e-3


def _small_vitb(cfg):
    """Real vit_b geometry at a 448-pixel input (JAX ``_small_vitb_cfg``)."""
    enc = dataclasses.replace(cfg.image_encoder, img_size=448)
    pe = dataclasses.replace(cfg.prompt_encoder, image_embedding_size=(28, 28),
                             input_image_size=(448, 448))
    return dataclasses.replace(cfg, image_encoder=enc, prompt_encoder=pe)


def _perturbed_model(cfg):
    """The port's seeded SAM with every parameter perturbed by 0.03 N(0, 1)."""
    model = build_sam(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.03 * torch.randn(p.shape, generator=gen))
    return model


def _iou(a, b):
    inter = (a & b).sum(axis=(1, 2))
    union = (a | b).sum(axis=(1, 2))
    return inter / np.maximum(union, 1)


def test_int8_serving_mask_agreement_vit_b():
    jcfg = _small_vitb(sam_vit_b_config())
    cfg = _small_vitb(torch_vit_b_config())
    model = _perturbed_model(cfg)
    params = jconvert.sam_params_from_torch(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)

    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 3, 448, 448)).astype(np.float32) * 50 + 120
    xt = torch.from_numpy(x)
    enc = model.image_encoder
    feats32 = enc(xt, dtype=torch.float32)
    feats_bf16 = enc(xt, dtype=torch.bfloat16)
    feats_int8 = enc(xt, dtype=torch.bfloat16, packed=prequantize_sam(model, torch.bfloat16),
                     ops=default_ops("int8"))

    assert not torch.equal(feats_int8, feats_bf16)     # the int8 path quantized something
    want32 = np.asarray(jax.jit(
        lambda p, x: jimage_encoder.apply(p, jcfg.image_encoder, x, dtype=jnp.float32))(
            params["image_encoder"], x))
    np.testing.assert_allclose(feats32.numpy(), want32, atol=FEATURE_TOL * np.abs(want32).max(),
                               rtol=0)

    n_cls = 6
    boxes = rng.uniform(40, 400, (n_cls, 2, 2)).astype(np.float32)
    coords = torch.from_numpy(np.sort(boxes, axis=1))
    labels = torch.tensor([[2, 3]], dtype=torch.int32).repeat(n_cls, 1)
    pe = model.prompt_encoder

    @torch.no_grad()
    def masks_and_quality(feats):
        low, iou = model.mask_decoder(feats, pe.get_dense_pe(),
                                      pe.embed_unified_points(coords, labels),
                                      pe.no_mask_dense(n_cls), multimask_output=False)
        return low[:, 0].numpy() > cfg.mask_threshold, iou.numpy()

    m32, q32 = masks_and_quality(feats32)
    mb, qb = masks_and_quality(feats_bf16)
    m8, q8 = masks_and_quality(feats_int8)
    iou_bf16, iou_int8 = _iou(m32, mb), _iou(m32, m8)
    drift_bf16, drift_int8 = np.abs(qb - q32).max(), np.abs(q8 - q32).max()
    print(f"mask IoU vs fp32: bf16 {iou_bf16.min():.4f}  int8 {iou_int8.min():.4f}; "
          f"quality drift: bf16 {drift_bf16:.4f}  int8 {drift_int8:.4f}")
    assert m32.any(axis=(1, 2)).all()          # every box decodes to a mask
    assert iou_int8.min() > INT8_IOU_MIN, iou_int8
    assert drift_int8 < INT8_QUALITY_DRIFT_MAX, drift_int8
    assert iou_int8.min() > iou_bf16.min() - INT8_BELOW_BF16_MAX, (iou_int8, iou_bf16)
