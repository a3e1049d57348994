"""Weight loaders of the port.

Three sources:

* :func:`sam_state_dict_from_jax` maps the JAX package's SAM parameter pytree
  (nested dicts of numpy arrays) to this package's state dict, undoing the
  JAX storage conventions:

  - linear weights (in, out) -> (out, in);
  - conv weights HWIO -> OIHW;
  - transposed-conv weights are stored (kh, kw, in, out) AND spatially
    flipped for ``lax.conv_transpose``; they go back to torch's
    (in, out, kh, kw) un-flipped;
  - the stacked hypernetwork MLPs are split back into one MLP per mask token.

  :func:`sam_params_from_state_dict` is its inverse (JAX
  ``sam_params_from_torch``): the port's state dict back to that pytree,
  for the decoder export's graph builder (``export/onnx_graph.py``).

* :func:`sam_state_dict_from_torch` / :func:`load_reference_checkpoint` take
  a reference SAM state dict (``sam_vit_h_4b8939.pth`` and the goldens'
  ``sd/`` keys), whose names are already this package's.

* :func:`unet_state_dict_from_jax` maps the JAX package's U-Net pytree to
  :class:`~samcarriestheburden_torch.models.unet.UNet`'s state dict (the
  same conventions); :func:`unet_params_from_torch` is its inverse (JAX
  ``unet_params_from_torch``), for files the JAX package reads;
  :func:`load_reference_unet` reads a reference U-Net bundle;
  :func:`adamw_state_from_jax` carries the JAX trainer's AdamW moments
  across with the weights, so a run started by either package resumes in
  the port.

* :func:`encoder_pack_from_jax_prequantized` carries the JAX package's
  *prequantized* encoder blocks (its ``models/quantize.py`` pytree: int8
  ``qkv_hm`` with 128-lane head padding, int8 ``mlp.lin1``/``lin2``) across
  into the port's int8 pack, without requantizing anything.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from samcarriestheburden_torch.config import ImageEncoderConfig, SamConfig, UNetConfig
from samcarriestheburden_torch.kernels.attention import prepare_rel_tables

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, np.float32))


def _lin(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[prefix + ".bias"] = _t(p["b"])


def _conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    if "b" in p:
        sd[prefix + ".bias"] = _t(p["b"])


def _conv_t(sd: StateDict, prefix: str, p: Mapping) -> None:
    w = np.asarray(p["w"])[::-1, ::-1]                  # un-flip (kh, kw, in, out)
    sd[prefix + ".weight"] = _t(w.transpose(2, 3, 0, 1))
    if "b" in p:
        sd[prefix + ".bias"] = _t(p["b"])


def _ln(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _attn(sd: StateDict, prefix: str, p: Mapping) -> None:
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _lin(sd, f"{prefix}.{name}", p[name])


def _image_encoder(sd: StateDict, p: Mapping, cfg, prefix: str) -> None:
    _conv(sd, prefix + "patch_embed.proj", p["patch_embed"])
    if cfg.use_abs_pos:
        sd[prefix + "pos_embed"] = _t(p["pos_embed"])
    for i, blk in enumerate(p["blocks"]):
        b = f"{prefix}blocks.{i}"
        _ln(sd, b + ".norm1", blk["norm1"])
        _lin(sd, b + ".attn.qkv", blk["attn"]["qkv"])
        _lin(sd, b + ".attn.proj", blk["attn"]["proj"])
        if cfg.use_rel_pos:
            sd[b + ".attn.rel_pos_h"] = _t(blk["attn"]["rel_pos_h"])
            sd[b + ".attn.rel_pos_w"] = _t(blk["attn"]["rel_pos_w"])
        _ln(sd, b + ".norm2", blk["norm2"])
        _lin(sd, b + ".mlp.lin1", blk["mlp"]["lin1"])
        _lin(sd, b + ".mlp.lin2", blk["mlp"]["lin2"])
    neck = p["neck"]
    _conv(sd, prefix + "neck.0", neck["conv1"])
    _ln(sd, prefix + "neck.1", neck["ln1"])
    _conv(sd, prefix + "neck.2", neck["conv2"])
    _ln(sd, prefix + "neck.3", neck["ln2"])


def _prompt_encoder(sd: StateDict, p: Mapping, prefix: str) -> None:
    sd[prefix + "pe_layer.positional_encoding_gaussian_matrix"] = _t(p["pe_gaussian"])
    for i, row in enumerate(np.asarray(p["point_embeddings"])):
        sd[f"{prefix}point_embeddings.{i}.weight"] = _t(row[None])
    sd[prefix + "not_a_point_embed.weight"] = _t(p["not_a_point_embed"])
    sd[prefix + "no_mask_embed.weight"] = _t(p["no_mask_embed"])
    md = p["mask_downscaling"]
    for idx, name in ((0, "conv1"), (3, "conv2"), (6, "conv3")):
        _conv(sd, f"{prefix}mask_downscaling.{idx}", md[name])
    _ln(sd, prefix + "mask_downscaling.1", md["ln1"])
    _ln(sd, prefix + "mask_downscaling.4", md["ln2"])


def _mask_decoder(sd: StateDict, p: Mapping, prefix: str) -> None:
    tr = p["transformer"]
    for i, layer in enumerate(tr["layers"]):
        b = f"{prefix}transformer.layers.{i}"
        for name in ("self_attn", "cross_attn_token_to_image",
                     "cross_attn_image_to_token"):
            _attn(sd, f"{b}.{name}", layer[name])
        for name in ("norm1", "norm2", "norm3", "norm4"):
            _ln(sd, f"{b}.{name}", layer[name])
        _lin(sd, b + ".mlp.lin1", layer["mlp"]["lin1"])
        _lin(sd, b + ".mlp.lin2", layer["mlp"]["lin2"])
    _attn(sd, prefix + "transformer.final_attn_token_to_image",
          tr["final_attn_token_to_image"])
    _ln(sd, prefix + "transformer.norm_final_attn", tr["norm_final_attn"])
    sd[prefix + "iou_token.weight"] = _t(p["iou_token"])
    sd[prefix + "mask_tokens.weight"] = _t(p["mask_tokens"])
    up = p["output_upscaling"]
    _conv_t(sd, prefix + "output_upscaling.0", up["up1"])
    _ln(sd, prefix + "output_upscaling.1", up["ln"])
    _conv_t(sd, prefix + "output_upscaling.3", up["up2"])
    hyper = p["output_hypernetworks_mlps"]["layers"]      # stacked over tokens
    for t in range(np.asarray(hyper[0]["w"]).shape[0]):
        for j, layer in enumerate(hyper):
            _lin(sd, f"{prefix}output_hypernetworks_mlps.{t}.layers.{j}",
                 {"w": np.asarray(layer["w"])[t], "b": np.asarray(layer["b"])[t]})
    for j, layer in enumerate(p["iou_prediction_head"]["layers"]):
        _lin(sd, f"{prefix}iou_prediction_head.layers.{j}", layer)


def sam_state_dict_from_jax(params: Mapping, cfg: SamConfig) -> StateDict:
    """The JAX package's SAM params (``sam.init`` / ``sam_params_from_torch``
    layout, numpy leaves) -> a state dict for :class:`SamModel`."""
    sd: StateDict = {}
    _image_encoder(sd, params["image_encoder"], cfg.image_encoder, "image_encoder.")
    _prompt_encoder(sd, params["prompt_encoder"], "prompt_encoder.")
    _mask_decoder(sd, params["mask_decoder"], "mask_decoder.")
    return sd


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t, np.float32)


def _lin_p(sd: Mapping, prefix: str) -> dict:
    p = {"w": np.ascontiguousarray(sd[prefix + ".weight"].T)}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _conv_p(sd: Mapping, prefix: str) -> dict:
    p = {"w": np.ascontiguousarray(sd[prefix + ".weight"].transpose(2, 3, 1, 0))}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _conv_t_p(sd: Mapping, prefix: str) -> dict:
    w = sd[prefix + ".weight"].transpose(2, 3, 0, 1)      # (kh, kw, in, out)
    p = {"w": np.ascontiguousarray(w[::-1, ::-1])}        # flipped for lax.conv_transpose
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _ln_p(sd: Mapping, prefix: str) -> dict:
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _attn_p(sd: Mapping, prefix: str) -> dict:
    return {name: _lin_p(sd, f"{prefix}.{name}")
            for name in ("q_proj", "k_proj", "v_proj", "out_proj")}


def _image_encoder_p(sd: Mapping, cfg, prefix: str) -> dict:
    blocks = []
    for i in range(cfg.depth):
        b = f"{prefix}blocks.{i}"
        blk = {"norm1": _ln_p(sd, b + ".norm1"),
               "attn": {"qkv": _lin_p(sd, b + ".attn.qkv"), "proj": _lin_p(sd, b + ".attn.proj")},
               "norm2": _ln_p(sd, b + ".norm2"),
               "mlp": {"lin1": _lin_p(sd, b + ".mlp.lin1"), "lin2": _lin_p(sd, b + ".mlp.lin2")}}
        if cfg.use_rel_pos:
            blk["attn"]["rel_pos_h"] = sd[b + ".attn.rel_pos_h"]
            blk["attn"]["rel_pos_w"] = sd[b + ".attn.rel_pos_w"]
        blocks.append(blk)
    params = {"patch_embed": _conv_p(sd, prefix + "patch_embed.proj"), "blocks": blocks,
              "neck": {"conv1": _conv_p(sd, prefix + "neck.0"), "ln1": _ln_p(sd, prefix + "neck.1"),
                       "conv2": _conv_p(sd, prefix + "neck.2"), "ln2": _ln_p(sd, prefix + "neck.3")}}
    if cfg.use_abs_pos:
        params["pos_embed"] = sd[prefix + "pos_embed"]
    return params


def _prompt_encoder_p(sd: Mapping, prefix: str) -> dict:
    return {
        "pe_gaussian": sd[prefix + "pe_layer.positional_encoding_gaussian_matrix"],
        "point_embeddings": np.concatenate(
            [sd[f"{prefix}point_embeddings.{i}.weight"] for i in range(4)], axis=0),
        "not_a_point_embed": sd[prefix + "not_a_point_embed.weight"],
        "no_mask_embed": sd[prefix + "no_mask_embed.weight"],
        "mask_downscaling": {
            "conv1": _conv_p(sd, prefix + "mask_downscaling.0"),
            "ln1": _ln_p(sd, prefix + "mask_downscaling.1"),
            "conv2": _conv_p(sd, prefix + "mask_downscaling.3"),
            "ln2": _ln_p(sd, prefix + "mask_downscaling.4"),
            "conv3": _conv_p(sd, prefix + "mask_downscaling.6"),
        },
    }


def _mask_decoder_p(sd: Mapping, cfg, prefix: str) -> dict:
    tr = prefix + "transformer"
    layers = []
    for i in range(cfg.transformer_depth):
        b = f"{tr}.layers.{i}"
        layers.append({
            "self_attn": _attn_p(sd, b + ".self_attn"),
            "norm1": _ln_p(sd, b + ".norm1"),
            "cross_attn_token_to_image": _attn_p(sd, b + ".cross_attn_token_to_image"),
            "norm2": _ln_p(sd, b + ".norm2"),
            "mlp": {"lin1": _lin_p(sd, b + ".mlp.lin1"), "lin2": _lin_p(sd, b + ".mlp.lin2")},
            "norm3": _ln_p(sd, b + ".norm3"),
            "norm4": _ln_p(sd, b + ".norm4"),
            "cross_attn_image_to_token": _attn_p(sd, b + ".cross_attn_image_to_token"),
        })
    nt = cfg.num_mask_tokens
    hyper = [[_lin_p(sd, f"{prefix}output_hypernetworks_mlps.{t}.layers.{j}") for j in range(3)]
             for t in range(nt)]
    return {
        "transformer": {
            "layers": layers,
            "final_attn_token_to_image": _attn_p(sd, tr + ".final_attn_token_to_image"),
            "norm_final_attn": _ln_p(sd, tr + ".norm_final_attn"),
        },
        "iou_token": sd[prefix + "iou_token.weight"],
        "mask_tokens": sd[prefix + "mask_tokens.weight"],
        "output_upscaling": {
            "up1": _conv_t_p(sd, prefix + "output_upscaling.0"),
            "ln": _ln_p(sd, prefix + "output_upscaling.1"),
            "up2": _conv_t_p(sd, prefix + "output_upscaling.3"),
        },
        "output_hypernetworks_mlps": {"layers": [
            {"w": np.stack([hyper[t][j]["w"] for t in range(nt)]),
             "b": np.stack([hyper[t][j]["b"] for t in range(nt)])} for j in range(3)]},
        "iou_prediction_head": {"layers": [
            _lin_p(sd, f"{prefix}iou_prediction_head.layers.{j}")
            for j in range(cfg.iou_head_depth)]},
    }


def sam_params_from_state_dict(sd: Mapping, cfg: SamConfig) -> dict:
    """A state dict of :class:`SamModel` -> the JAX package's SAM params
    pytree of numpy fp32 arrays (JAX ``sam_params_from_torch``'s layout);
    the inverse of :func:`sam_state_dict_from_jax`, by transposes, the
    transposed convs' spatial flip and the hypernetworks' stacking alone.
    ``image_encoder`` is in the tree only where ``sd`` has its keys (a
    decoder's state dict gives ``prompt_encoder`` and ``mask_decoder``)."""
    sd = {k: _np(v) for k, v in sd.items()}
    params = {}
    if any(k.startswith("image_encoder.") for k in sd):
        params["image_encoder"] = _image_encoder_p(sd, cfg.image_encoder, "image_encoder.")
    params["prompt_encoder"] = _prompt_encoder_p(sd, "prompt_encoder.")
    params["mask_decoder"] = _mask_decoder_p(sd, cfg.mask_decoder, "mask_decoder.")
    return params


def _double_conv(sd: StateDict, prefix: str, p: Mapping) -> None:
    # Sequential: 0 conv, 1 InstanceNorm, 2 LeakyReLU, 3 conv, 4 InstanceNorm
    _conv(sd, prefix + ".double_conv.0", p["conv1"])
    _ln(sd, prefix + ".double_conv.1", p["in1"])
    _conv(sd, prefix + ".double_conv.3", p["conv2"])
    _ln(sd, prefix + ".double_conv.4", p["in2"])


#: (JAX key, state dict prefix) of every double conv of the U-Net
UNET_BLOCKS = ([("inc", "inc")] + [(f"down{i}", f"down{i}.maxpool_conv.1") for i in range(1, 5)]
               + [(f"up{i}", f"up{i}.conv") for i in range(1, 5)])


def unet_state_dict_from_jax(params: Mapping, cfg: UNetConfig) -> StateDict:
    """The JAX package's U-Net params (``unet.init`` / ``unet_params_from_torch``
    layout, numpy leaves) -> a state dict for ``UNet(cfg)``: HWIO convs back
    to OIHW, the transposed convs' flipped (kh, kw, in, out) back to
    (in, out, kh, kw)."""
    sd: StateDict = {}
    for key, prefix in UNET_BLOCKS:
        node = params[key]["conv"] if key.startswith("up") else params[key]
        _double_conv(sd, prefix, node)
        if key.startswith("up") and not cfg.bilinear:
            _conv_t(sd, f"{key}.up", params[key]["up"])
    _conv(sd, "outc.conv", params["outc"])
    return sd


def unet_params_from_torch(sd: Mapping, cfg: UNetConfig) -> dict:
    """A U-Net state dict (this package's or the reference's names) -> the
    JAX package's params pytree of numpy arrays (JAX
    ``convert.unet_params_from_torch``)."""
    def conv(prefix, bias=True):
        p = {"w": np.ascontiguousarray(_np(sd[prefix + ".weight"]).transpose(2, 3, 1, 0))}
        if bias and prefix + ".bias" in sd:
            p["b"] = _np(sd[prefix + ".bias"])
        return p

    def double_conv(prefix):
        return {"conv1": conv(prefix + ".double_conv.0", bias=False),
                "in1": {"scale": _np(sd[prefix + ".double_conv.1.weight"]),
                        "bias": _np(sd[prefix + ".double_conv.1.bias"])},
                "conv2": conv(prefix + ".double_conv.3", bias=False),
                "in2": {"scale": _np(sd[prefix + ".double_conv.4.weight"]),
                        "bias": _np(sd[prefix + ".double_conv.4.bias"])}}

    params = {}
    for key, prefix in UNET_BLOCKS:
        params[key] = {"conv": double_conv(prefix)} if key.startswith("up") \
            else double_conv(prefix)
        if key.startswith("up") and not cfg.bilinear:
            w = _np(sd[f"{key}.up.weight"]).transpose(2, 3, 0, 1)      # (kh, kw, in, out)
            params[key]["up"] = {"w": np.ascontiguousarray(w[::-1, ::-1]),
                                 "b": _np(sd[f"{key}.up.bias"])}
    params["outc"] = conv("outc.conv")
    return params


def adamw_state_from_jax(mu: Mapping, nu: Mapping, count, cfg: UNetConfig,
                         param_names: Sequence[str]) -> dict:
    """The JAX trainer's AdamW state (``optax.adamw``'s first and second
    moments ``mu`` and ``nu``, U-Net pytrees of numpy arrays, and its step
    ``count``) -> the ``state`` of a ``torch.optim.AdamW.state_dict()`` over
    the U-Net's parameters in the order of ``param_names`` (``[n for n, _ in
    UNet.named_parameters()]``).  The moments move through the weights'
    layout change (HWIO to OIHW; the transposed convs un-flipped), which is a
    permutation of each tensor.  optax's update, m̂ / (sqrt(v̂) + eps) with
    both bias corrections at the same step, is torch AdamW's."""
    m = unet_state_dict_from_jax(mu, cfg)
    v = unet_state_dict_from_jax(nu, cfg)
    if set(param_names) != set(m):
        raise ValueError(f"parameter names {sorted(set(param_names) ^ set(m))} do not match")
    return {i: {"step": torch.tensor(float(np.asarray(count))), "exp_avg": m[name],
                "exp_avg_sq": v[name]}
            for i, name in enumerate(param_names)}


def load_reference_unet(path):
    """A reference LoadableModel U-Net bundle (``{'config', 'model_state'}``,
    reference custom_arcitecture/modelio.py:67-86) -> (UNetConfig, state
    dict); the names are already this package's (JAX ``load_reference_unet``)."""
    with open(path, "rb") as f:
        bundle = torch.load(f, map_location="cpu", weights_only=True)
    if not (isinstance(bundle, dict) and "model_state" in bundle):
        raise ValueError(f"{path} is not a LoadableModel bundle")
    raw = bundle["config"]
    cfg = UNetConfig(n_channels=raw["n_channels"], n_classes=raw["n_classes"],
                     bilinear=raw.get("bilinear", False),
                     n_last_channel=raw.get("n_last_channel", 64))
    return cfg, {k: torch.as_tensor(v).float() for k, v in bundle["model_state"].items()}


def _int8_linear(p: Mapping, keep=None):
    """A JAX prequantized linear {wq (I, O) int8, s (1, O), b (O,)} -> wq
    (O', I) int8, s (O',), b (O',) fp32; ``keep`` indexes the output channels
    that survive (the rest is layout padding)."""
    wq = np.asarray(p["wq"]).T
    s = np.asarray(p["s"], np.float32).reshape(-1)
    b = np.asarray(p["b"], np.float32).reshape(-1)
    if keep is not None:
        wq, s, b = wq[keep], s[keep], b[keep]
    return (torch.tensor(np.ascontiguousarray(wq, np.int8)), torch.tensor(s.copy()),
            torch.tensor(b.copy()))


def encoder_pack_from_jax_prequantized(params: Mapping, cfg: ImageEncoderConfig,
                                       dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
    """The JAX package's prequantized image-encoder params (the pytree of its
    ``prequantize_image_encoder``, numpy leaves) -> the port's per-block int8
    pack (``ImageEncoderViT.pack(dtype, quantize="int8")``'s layout).

    The JAX qkv pack groups each head's [q | k | v] columns and pads the
    group with zero columns to a multiple of 128 lanes; the padding is
    stripped and the int8 matrices are transposed to ``(out, in)``.  The
    patch embed, pos embed and neck stay in the model's state dict."""
    heads, hd = cfg.num_heads, cfg.head_dim
    packed = []
    for i, blk in enumerate(params["blocks"]):
        attn = blk["attn"]
        group = np.asarray(attn["qkv_hm"]["wq"]).shape[1] // heads       # padded width
        keep = (np.arange(heads)[:, None] * group + np.arange(3 * hd)[None]).reshape(-1)
        s = cfg.grid_size if i in cfg.global_attn_indexes else cfg.window_size
        pk = {"norm1_w": _t(blk["norm1"]["scale"]), "norm1_b": _t(blk["norm1"]["bias"]),
              "tables": prepare_rel_tables(_t(attn["rel_pos_h"]), _t(attn["rel_pos_w"]),
                                           s, s, dtype),
              "proj_w": _t(np.asarray(attn["proj"]["w"]).T).to(dtype),
              "proj_b": _t(attn["proj"]["b"]).to(dtype),
              "norm2_w": _t(blk["norm2"]["scale"]), "norm2_b": _t(blk["norm2"]["bias"])}
        pk["qkv_wq"], pk["qkv_s"], pk["qkv_b"] = _int8_linear(attn["qkv_hm"], keep)
        for name in ("lin1", "lin2"):
            pk[f"{name}_wq"], pk[f"{name}_s"], pk[f"{name}_b"] = _int8_linear(blk["mlp"][name])
        packed.append(pk)
    return packed


def sam_state_dict_from_torch(sd: Mapping) -> StateDict:
    """A reference SAM state dict (tensors or numpy arrays, names as in
    segment_anything) -> this package's state dict: the names are the same,
    the values become fp32 tensors."""
    return {k: torch.as_tensor(v).float() for k, v in sd.items()}


def load_reference_checkpoint(path) -> StateDict:
    """Read a reference ``.pth`` SAM checkpoint (e.g. ``sam_vit_h_4b8939.pth``)."""
    with open(path, "rb") as f:
        sd = torch.load(f, map_location="cpu", weights_only=True)
    return sam_state_dict_from_torch(sd)


def _unflatten(flat: Mapping[str, np.ndarray]):
    """'/'-joined keys -> the nested pytree, all-digit levels as lists."""
    root: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = root
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_jax_decoder_checkpoint(path) -> StateDict:
    """The prompt encoder and mask decoder of a JAX-package ``.npz`` SAM
    checkpoint (its params flattened to '/'-joined keys, an optional JSON
    config under ``__config__``) as a state dict with this package's names."""
    with np.load(path, allow_pickle=False) as data:
        params = _unflatten({k: data[k] for k in data.files if k != "__config__"})
    sd: StateDict = {}
    _prompt_encoder(sd, params["prompt_encoder"], "prompt_encoder.")
    _mask_decoder(sd, params["mask_decoder"], "mask_decoder.")
    return sd
