"""The port's pseudo-label pipeline against the JAX package, on the CPU: the
mask bit-packing, the mask and model files read across the two packages in
both directions, ``precompute_embeddings`` (and its ``resume``), and the four
CLIs on the conftest ``data_root`` with a base-4 U-Net saved through the JAX
``ModelRegistry``, their h5 files held against the JAX functions' outputs on
the same inputs.  SAM: vit_t with the reference-derived ``sam_e2e`` golden,
fp32."""

import json
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samcarriestheburden_torch.cli import generate_img_embeddings as t_gen
from samcarriestheburden_torch.cli import save_refined_segmentations as t_refine
from samcarriestheburden_torch.cli import save_segmentations as t_seg
from samcarriestheburden_torch.cli import select_pseudo_labels as t_select
from samcarriestheburden_torch.config import UNetConfig as TorchUNetConfig
from samcarriestheburden_torch.data import h5io as th5
from samcarriestheburden_torch.engine import embeddings as temb
from samcarriestheburden_torch.models import build as tbuild
from samcarriestheburden_torch.models import convert as tconvert
from samcarriestheburden_torch.models import modelio as tmodelio
from samcarriestheburden_torch.models.unet import build_unet, unet_probabilities
from samcarriestheburden_torch.ops import mask_ops as tmask_ops
from samcarriestheburden_tpu.cli import select_pseudo_labels as j_select
from samcarriestheburden_tpu.config import GRAZ_IMG_MEAN, GRAZ_IMG_STD, UNetConfig
from samcarriestheburden_tpu.config import sam_vit_t_config
from samcarriestheburden_tpu.data import h5io as jh5
from samcarriestheburden_tpu.engine import embeddings as jemb
from samcarriestheburden_tpu.engine.decoder_head import SamMaskDecoderHead as JaxHead
from samcarriestheburden_tpu.engine.refinement import SamSegRefiner as JaxRefiner
from samcarriestheburden_tpu.engine.refinement import SegEnhance as JaxEnhance
from samcarriestheburden_tpu.models import convert as jconvert
from samcarriestheburden_tpu.models import modelio as jmodelio
from samcarriestheburden_tpu.models import unet as junet
from samcarriestheburden_tpu.models.sam import SamModel as JaxSam
from samcarriestheburden_tpu.ops import mask_ops as jmask_ops

# the tier-1 command runs six xdist workers on the machine's cores: one
# intra-op thread each, or their thread pools oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
CFG = sam_vit_t_config()
UNET_CFG = dict(base_channels=4, n_last_channel=4)
#: the encoder's tolerance of the port against JAX at vit_t, fp32
EMB_TOL = 2e-4
#: U-Net probabilities, port against JAX on the CPU, fp32
PROB_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_sam():
    data = np.load(GOLDEN / "sam_e2e.npz")
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd/")}
    return JaxSam(cfg=CFG, params=jconvert.sam_params_from_torch(sd, CFG))


@pytest.fixture
def sam_ckpt(tmp_path, jax_sam):
    """The golden SAM saved as a JAX-package ``.npz`` params file."""
    return jmodelio.save_params(tmp_path / "tiny.npz", jax_sam.params)


_jax_unet_apply = jax.jit(junet.apply, static_argnums=1)


def _jax_unet_params(seed=0):
    """A seeded base-4 U-Net as the JAX package's params pytree, whose classes
    each cover a few percent of the pixels at most and rarely overlap, as a
    trained one's do: the output layer's weights scaled by 3 and its biases
    set to -3 (at init the classes cover about half of every image each, so
    no class has a seed)."""
    cfg = TorchUNetConfig(**UNET_CFG)
    params = tconvert.unet_params_from_torch(
        build_unet(cfg, device="cpu", seed=seed).state_dict(), cfg)
    params["outc"] = {"w": params["outc"]["w"] * 3, "b": np.full((17,), -3.0, np.float32)}
    return params


def test_configs_and_constants_match_jax():
    """The copied config classes serialise to the JAX package's JSON and back,
    and the dataset constants are its own."""
    from samcarriestheburden_torch import config as tcfg
    from samcarriestheburden_tpu import config as jcfg

    for name, kw in (("UNetConfig", dict(base_channels=4, bilinear=True)),
                     ("RefineConfig", dict(prompts_second=None, radius=3))):
        t, j = getattr(tcfg, name)(**kw), getattr(jcfg, name)(**kw)
        assert t.to_json() == j.to_json()
        assert getattr(tcfg, name).from_json(j.to_json()) == t
        assert getattr(jcfg, name).from_json(t.to_json()) == j
    assert tcfg.BONE_LABEL == jcfg.BONE_LABEL and tcfg.BONE_LABEL_MAPPING == jcfg.BONE_LABEL_MAPPING
    assert tcfg.N_CLASSES == len(tcfg.BONE_LABEL) == jcfg.N_CLASSES
    assert (tcfg.GRAZ_IMG_MEAN, tcfg.GRAZ_IMG_STD) == (jcfg.GRAZ_IMG_MEAN, jcfg.GRAZ_IMG_STD)


def test_packbits_match_jax():
    masks = np.random.default_rng(0).random((3, 17, 6, 224)) > 0.5
    got = tmask_ops.packbits_device(torch.from_numpy(masks))
    want = np.asarray(jmask_ops.packbits_device(jnp.asarray(masks)))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, 17, 6, 28)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmask_ops.unpackbits_host(got.numpy(), 224), masks)
    np.testing.assert_array_equal(tmask_ops.unpackbits_host(want, 224),
                                  jmask_ops.unpackbits_host(want, 224))
    with pytest.raises(ValueError, match="multiple of 8"):
        tmask_ops.packbits_device(torch.from_numpy(masks[..., :12]))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mask_files_interoperate(tmp_path, writer):
    """A mask h5 one package writes reads in the other: masks, labels,
    ``estimated_dice`` (present and absent), file attrs, ``check_labels``."""
    rng = np.random.default_rng(1)
    masks = {s: (rng.random((17, 12, 8)) > 0.5).astype(np.uint8) for s in ("a", "b")}
    dice = rng.random(17)
    write_mod, read_mod = (th5, jh5) if writer == "port" else (jh5, th5)
    path = tmp_path / "masks.h5"
    with write_mod.MaskWriter(path, attrs={"model_id": "m1"}) as w:
        w.write("a", masks["a"], estimated_dice=dice)
        w.write("b", masks["b"])
    r = read_mod.MaskReader(path)
    assert r.labels == th5.BONE_LABEL_MAPPING == jh5.BONE_LABEL_MAPPING
    assert sorted(r.stems()) == ["a", "b"] and r.f.attrs["model_id"] == "m1"
    for s in ("a", "b"):
        np.testing.assert_array_equal(r.masks(s), masks[s])
    np.testing.assert_array_equal(r.estimated_dice("a"), dice)
    assert r.estimated_dice("b").ndim == 0
    r.close()
    other = tmp_path / "other.h5"
    with write_mod.MaskWriter(other, labels={"x": 0}) as w:
        w.write("a", masks["a"])
    with pytest.raises((AssertionError, ValueError)):
        read_mod.MaskReader(other)
    r = read_mod.MaskReader(other, check_labels=False)
    assert r.labels == {"x": 0}
    r.close()


def test_memory_masks_read_as_the_file():
    store = th5.MemoryMasks()
    m = np.ones((17, 4, 8), np.uint8)
    store.write("a", m, estimated_dice=np.arange(17.0))
    store.write("b", m)
    m[:] = 0                                   # the store keeps a copy
    assert store.labels == th5.BONE_LABEL_MAPPING and store.stems() == ["a", "b"]
    assert store.masks("a").all() and store.estimated_dice("a")[3] == 3.0
    assert store.estimated_dice("b").ndim == 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_model_files_interoperate(tmp_path, writer):
    """``save_model`` and ``ModelRegistry`` files read across the packages:
    the same weights get the same registry id in both, and the U-Net the
    port loads computes JAX ``unet.apply``'s logits."""
    params = _jax_unet_params(3)
    jcfg, tcfg = UNetConfig(**UNET_CFG), TorchUNetConfig(**UNET_CFG)
    x = np.random.default_rng(2).standard_normal((1, 1, 40, 24)).astype(np.float32)
    want = np.asarray(_jax_unet_apply(params, jcfg, x))
    j_reg, t_reg = jmodelio.ModelRegistry(tmp_path / "j"), tmodelio.ModelRegistry(tmp_path / "t")
    if writer == "jax":
        model_id = j_reg.register(jcfg, params, name="theta", metadata={"val_dice": 0.5})
        jmodelio.save_model(tmp_path / "m.npz", jcfg, params)
        reg = tmodelio.ModelRegistry(tmp_path / "j")
        assert reg.list()[0]["id"] == model_id and reg.list()[0]["val_dice"] == 0.5
        cfg, unet = reg.load(model_id, device="cpu")
        assert cfg == tcfg
        with torch.no_grad():
            got = unet(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        cfg, loaded = tmodelio.load_model(tmp_path / "m.npz")
        assert cfg == tcfg
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(loaded),
                                                         jax.tree.leaves(params)))
        assert model_id == t_reg.register(tcfg, loaded)
    else:
        _, unet = tmodelio.ModelRegistry(tmp_path / "j").load(
            j_reg.register(jcfg, params), device="cpu")
        model_id = t_reg.register(tcfg, unet, name="phi")
        tmodelio.save_model(tmp_path / "m.npz", tcfg, unet.state_dict())
        reg = jmodelio.ModelRegistry(tmp_path / "t")
        assert reg.list()[0]["id"] == model_id and reg.list()[0]["name"] == "phi"
        cfg, loaded = reg.load(model_id)
        assert cfg == jcfg
        np.testing.assert_allclose(np.asarray(_jax_unet_apply(loaded, cfg, x)), want, atol=1e-6)
        cfg, loaded = jmodelio.load_model(tmp_path / "m.npz")
        assert cfg == jcfg and model_id == j_reg.register(cfg, loaded)


def _read_embeddings(reader_mod, path):
    r = reader_mod.EmbeddingReader(path)
    out = {s: (r.features(s), *r.sizes(s)) for s in r.stems()}
    meta = (str(r.checkpoint), r.img_encoder_img_size)
    r.close()
    return out, meta


def _assert_embeddings_match(got_path, want_path, stems):
    got, got_meta = _read_embeddings(th5, got_path)
    want, want_meta = _read_embeddings(jh5, want_path)
    assert sorted(got) == sorted(want) == sorted(stems) and got_meta == want_meta
    for s in stems:
        np.testing.assert_allclose(got[s][0], want[s][0], atol=EMB_TOL, rtol=0)
        for a, b in zip(got[s][1:], want[s][1:]):
            np.testing.assert_array_equal(a, b)


def test_precompute_embeddings_matches_jax(tmp_path, data_root, jax_sam, sam_ckpt,
                                           monkeypatch):
    """Three images at batch 2 (the last batch padded), fp32, against JAX
    ``precompute_embeddings``; then ``resume`` reads and encodes only the
    stems not yet stored."""
    files = sorted((data_root / "img_only_front_all_left").glob("*.png"))[:3]
    np.testing.assert_array_equal(temb.load_image_rgb(files[0]), jemb.load_image_rgb(files[0]))
    model = tbuild.sam_model_registry["vit_t"](checkpoint=sam_ckpt, device="cpu")
    ours, theirs = tmp_path / "ours.h5", tmp_path / "theirs.h5"
    temb.precompute_embeddings(model, files, ours, "tiny.npz", batch_size=2,
                               dtype=torch.float32, progress=False)
    jemb.precompute_embeddings(jax_sam, files, theirs, "tiny.npz", batch_size=2,
                               dtype=jnp.float32, progress=False)
    _assert_embeddings_match(ours, theirs, [f.stem for f in files])

    resumed = tmp_path / "resumed.h5"
    temb.precompute_embeddings(model, files[:2], resumed, "tiny.npz", batch_size=2,
                               dtype=torch.float32, progress=False)
    read = []
    load = temb.load_image_gray
    monkeypatch.setattr(temb, "load_image_gray", lambda f: read.append(Path(f).stem) or load(f))
    temb.precompute_embeddings(model, files, resumed, "tiny.npz", batch_size=2,
                               dtype=torch.float32, progress=False, resume=True)
    assert read == [files[2].stem]
    _assert_embeddings_match(resumed, theirs, [f.stem for f in files])
    with pytest.raises(ValueError, match="different checkpoint"):
        temb.precompute_embeddings(model, files, resumed, "other.npz", resume=True,
                                   progress=False)


def test_encode_images_writes_every_batch_to_any_writer():
    """The batch loop alone, on decoded images and an in-memory store: each
    embedding is the encoder's on its own padded batch, at every batch
    position and across reused buffers (5 batches of 2, the last padded);
    RGB and grayscale images (resized once, fed in three channels) alike."""
    model = tbuild.build_sam_vit_t(device="cpu")
    encode, packed = temb.make_serving_encoder(model, torch.float32)
    rng = np.random.default_rng(4)
    images = {f"s{i}": rng.integers(0, 256, (90 + 7 * i, 60, 3)).astype(np.uint8)
              for i in range(9)}
    for stem in ("s2", "s5"):
        images[stem] = images[stem][..., 0]
    store = th5.MemoryEmbeddings(model.img_size)
    temb.encode_images(encode, packed, list(images), images.__getitem__, store,
                       img_size=model.img_size, device="cpu", batch_size=2, loader_threads=3)
    assert store.stems() == list(images)
    for i, stem in enumerate(images):
        img = images[stem]
        if img.ndim == 2:                      # cv2.COLOR_GRAY2RGB
            img = np.repeat(img[..., None], 3, axis=2)
        img = temb.resize_longest_side_np(img, model.img_size)
        batch = torch.zeros((2, 3, 128, 128), dtype=torch.uint8)
        batch[i % 2, :, :img.shape[0], :img.shape[1]] = torch.from_numpy(img.transpose(2, 0, 1))
        sizes = torch.ones((2, 2), dtype=torch.int32)
        sizes[i % 2] = torch.tensor(img.shape[:2])
        want = encode(packed, batch, sizes)[i % 2:i % 2 + 1]
        np.testing.assert_allclose(store.features(stem), want.numpy(), atol=1e-5, rtol=0)
        original, input_size = store.sizes(stem)
        assert tuple(original) == images[stem].shape[:2] and tuple(input_size) == img.shape[:2]


@pytest.fixture
def registry_unet(data_root):
    """A base-4 U-Net in the data root's registry, saved by the JAX package."""
    params = _jax_unet_params(0)
    reg = jmodelio.ModelRegistry(data_root / "model_registry")
    return reg.register(UNetConfig(**UNET_CFG), params, name="theta"), params


def test_the_four_clis_match_the_jax_functions(data_root, jax_sam, sam_ckpt, registry_unet,
                                               monkeypatch):
    """generate_img_embeddings -> save_segmentations -> save_refined_segmentations
    -> select_pseudo_labels with ``--cpu``, each output held against the JAX
    functions on the same inputs: embeddings within the encoder's tolerance;
    the raw masks equal to JAX's U-Net thresholded at 0.5 wherever its
    probability is further than the U-Net's tolerance from 0.5; the refined
    masks and ``estimated_dice`` against JAX ``SegEnhance.enhance_batch``
    on the port's probability maps and embeddings, as
    ``test_torch_enhance.py`` holds them; the selection equal to the JAX
    CLI's on the same input."""
    monkeypatch.chdir(data_root.parent)
    model_id, params = registry_unet
    img_dir = data_root / "img_only_front_all_left"
    emb, emb_jax = data_root / "emb.h5", data_root / "emb_jax.h5"
    t_gen.main(["--cpu", "--model_type", "vit_t", "--checkpoint", str(sam_ckpt),
                "--img_dir", str(img_dir), "--output", str(emb), "--dtype", "float32",
                "--batch_size", "4"])
    files = sorted(img_dir.glob("*.png"))
    jemb.precompute_embeddings(jax_sam, files, emb_jax, "tiny.npz", batch_size=4,
                               dtype=jnp.float32, progress=False)
    _assert_embeddings_match(emb, emb_jax, [f.stem for f in files])

    stems = t_seg.select_unlabeled_files(str(data_root), "all")
    assert stems == ["img004", "img005"]
    imgs = np.stack([t_seg.read_unet_image(img_dir, s) for s in stems])
    x = (imgs[:, None].astype(np.float32) / 255.0 - GRAZ_IMG_MEAN) / GRAZ_IMG_STD
    probs_jax = np.asarray(jax.nn.sigmoid(_jax_unet_apply(params, UNetConfig(**UNET_CFG), x)))
    _, unet = tmodelio.ModelRegistry(data_root / "model_registry").load(model_id, "cpu")
    probs = unet_probabilities(unet, torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(probs, probs_jax, atol=PROB_TOL, rtol=0)

    t_seg.main(["--cpu", "--model_id", model_id, "--n_files", "all",
                "--data_root", str(data_root)])
    mdir = data_root / "seg_masks" / model_id
    with th5.MaskReader(mdir / "raw_segmentations_2.h5") as r:
        assert r.stems() == stems and r.f.attrs["model_id"] == model_id
        raw = np.stack([r.masks(s) for s in stems])
    np.testing.assert_array_equal(raw, (probs > 0.5).astype(np.uint8))
    sure = np.abs(probs_jax - 0.5) > PROB_TOL
    assert ((raw == (probs_jax > 0.5)) | ~sure).all()

    t_refine.main(["--cpu", "--model_id", model_id, "--n_files", "all",
                   "--data_root", str(data_root), "--sam_checkpoint", str(sam_ckpt),
                   "--sam_model_type", "vit_t", "--embeddings", str(emb), "--img_batch", "2"])
    name = "sam_box_refine_pos_points_neg_points_2.h5"
    with th5.MaskReader(mdir / name) as r:
        assert r.stems() == stems
        refined = np.stack([r.masks(s) for s in stems])
        est = np.stack([r.estimated_dice(s) for s in stems])
        params_attr = json.loads(r.f.attrs["refine_params"])
    assert params_attr["prompts2use"] == [["box"], ["pos_points", "neg_points"]]
    j_enh = JaxEnhance(JaxRefiner(JaxHead(str(sam_ckpt), "vit_t", str(emb)),
                                  prompts2use=params_attr["prompts2use"]),
                       "highest_probability", "dilation", "square", 8)
    j_refined, j_est = j_enh.enhance_batch(probs, stems)
    np.testing.assert_array_equal(refined, np.asarray(j_refined).astype(np.uint8))
    np.testing.assert_array_equal(np.isnan(est), np.isnan(np.asarray(j_est)))
    np.testing.assert_allclose(est, np.asarray(j_est), atol=1e-4)

    # the golden tiny SAM's IoU head is negative on these images: -0.5 keeps them
    argv = ["--model_id", model_id, "--input", name, "--threshold", "-0.5",
            "--data_root", str(data_root)]
    out = j_select.main(argv)
    r = jh5.MaskReader(out)
    want = {s: (r.masks(s), r.estimated_dice(s)) for s in r.stems()}
    r.close()
    assert t_select.main(argv) == out
    with th5.MaskReader(out) as r:
        assert sorted(r.stems()) == sorted(want)
        assert r.f.attrs["dsc_agreement_threshold"] == -0.5 and len(want) == 2
        for s, (m, d) in want.items():
            np.testing.assert_array_equal(r.masks(s), m)
            np.testing.assert_array_equal(r.estimated_dice(s), d)


def test_refine_images_packs_and_fetches_one_batch_late(sam_ckpt):
    """The sweep's loop alone, on decoded images on a 96 x 56 grid and
    in-memory stores, at ``img_batch`` 2 over three images (the last batch
    short) and at 1 (the per-image ``enhance``): every stem written once,
    with ``enhance_batch``'s masks and Dice on the same probability maps."""
    from samcarriestheburden_torch.engine.decoder_head import SamMaskDecoderHead
    from samcarriestheburden_torch.engine.refinement import SamSegRefiner, SegEnhance

    rng = np.random.default_rng(5)
    stems = ["img0", "img1", "img2"]
    store = th5.MemoryEmbeddings(128, checkpoint="tiny.npz")
    for s in stems:
        store.write(s, rng.standard_normal((1, 16, 8, 8)), (256, 150), (128, 75))
    unet = build_unet(TorchUNetConfig(**UNET_CFG), device="cpu", seed=0)
    with torch.no_grad():                      # sparse classes, as in _jax_unet_params
        unet.outc.conv.weight.mul_(3)
        unet.outc.conv.bias.fill_(-3)
    head = SamMaskDecoderHead(sam_ckpt, "vit_t", store, device="cpu")
    enh = SegEnhance(SamSegRefiner(head, prompts2use=[["box"], ["pos_points", "neg_points"]]),
                     "highest_probability", "dilation", "square", 8)
    images = {s: rng.integers(0, 256, (96, 56)).astype(np.uint8) for s in stems}
    probs = unet_probabilities(unet, torch.from_numpy(np.stack(list(images.values()))))
    want_masks, want_est = enh.enhance_batch(probs, stems)
    assert torch.isfinite(want_est).any()      # the decoder ran for some classes
    for img_batch, some in ((2, stems), (1, stems[:1])):
        masks = th5.MemoryMasks()
        t_refine.refine_images(unet, enh, some, images.__getitem__, masks, img_batch=img_batch)
        assert masks.stems() == some
        for i, s in enumerate(some):
            assert masks.masks(s).dtype == np.uint8
            np.testing.assert_array_equal(masks.masks(s), want_masks[i].numpy())
            np.testing.assert_allclose(masks.estimated_dice(s), want_est[i].numpy(),
                                       atol=1e-6, rtol=0)


def test_unported_options_raise(data_root):
    """The multi-process options in one process: ``--merge_shards`` without
    part files, ``--num_devices`` above the group (one card per process),
    ``--multihost`` without a coordinator or torchrun's environment; a
    precompute outside a group writes one file, no part and no shard count."""
    with pytest.raises(FileNotFoundError, match="part"):
        t_gen.main(["--cpu", "--merge_shards", "--output", str(data_root / "none.h5")])
    with pytest.raises(ValueError, match="nproc-per-node 2"):
        t_gen.main(["--cpu", "--num_devices", "2"])
    with pytest.raises(ValueError, match="torchrun"):
        t_gen.main(["--cpu", "--multihost"])
    model = tbuild.build_sam_vit_t(device="cpu")
    temb.precompute_embeddings(model, [], data_root / "e.h5", "c", progress=False)
    assert not list(data_root.glob("e.h5.part*"))
    with h5py.File(data_root / "e.h5", "r") as f:
        assert "shard_count" not in f.attrs
