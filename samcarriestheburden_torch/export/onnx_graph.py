"""ONNX graph emitter for the SAM decoder program.

Lowers the exact program of :func:`export.program.make_decoder_fn`
(reference ``segment_anything/utils/onnx.py`` SamOnnxModel +
``scripts/export_onnx_model.py:122-167``) to an opset-17 ONNX graph, built
by hand on the dependency-free wire codec in :mod:`export.onnx_proto` — this
environment has neither the ``onnx`` package nor onnxruntime, so the graph
is constructed node-by-node and validated by the numpy evaluator in
:mod:`export.onnx_eval`.  The weights are read from the port's model as the
JAX package's parameter tree (``models/convert.py:sam_params_from_state_dict``,
transposes and flips only), and the builder walks that tree as the JAX
package's builder does: for the same weights the two packages write the same
bytes (tests/test_torch_export.py).

Design notes:
* batch (``b``) and point (``n``) axes are dynamic (``dim_param``), like the
  reference export's ``dynamic_axes={'point_coords': {1: 'num_points'}}``;
  every Reshape uses 0/-1 semantics so the graph is shape-polymorphic.
* the dense positional-encoding grid and the (iou_token ‖ mask_tokens) row
  block are pure functions of the weights — baked as initializers.
* the 4× mask upscaling is emitted in the reference's own structure
  (ConvTranspose → LayerNorm2d → GELU → ConvTranspose → GELU): ONNX
  consumers get standard ops, not the TPU pre-shuffle matmul form (which is
  numerically identical; see models/mask_decoder._upscale_hyper_preshuffle).
* GELU is the exact erf form (torch ``nn.GELU()`` default); LayerNorm uses
  the native opset-17 ``LayerNormalization``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from samcarriestheburden_torch.export import onnx_proto as P

I64 = np.int64


class GraphBuilder:
    """Incremental ONNX GraphProto builder over the wire codec.

    Every method emits node(s) and returns the output tensor name (a str).
    numpy arrays passed where a tensor name is expected are auto-promoted to
    initializers, so ``g.add(x, np.float32(0.5))`` just works.
    """

    def __init__(self, name: str = "graph", quantize: Optional[str] = None):
        self.name = name
        self.nodes: List[bytes] = []
        self.inputs: List[bytes] = []
        self.outputs: List[bytes] = []
        self.initializers: List[bytes] = []
        self._n = 0
        self._const_cache: Dict[Any, str] = {}
        # 'int8': big weights stored as int8 initializers + per-tensor scale,
        # dequantized in-graph (DequantizeLinear) — the analogue of the
        # reference's onnxruntime quantize_dynamic (export_onnx_model.py:
        # 187-201) and of export.program.quantize_state_dict's int8 mode
        self.quantize = quantize
        self.quantize_min_size = 1024  # same gate as the program's int8 mode

    # -- naming / constants -------------------------------------------------

    def fresh(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def const(self, array: np.ndarray, name: Optional[str] = None) -> str:
        arr = np.asarray(array)
        key = None
        if name is None:
            key = (arr.dtype.str, arr.shape, arr.tobytes())
            if key in self._const_cache:
                return self._const_cache[key]
            name = self.fresh("c")
        self.initializers.append(P.make_tensor(name, arr))
        if key is not None:
            self._const_cache[key] = name
        return name

    def _name(self, x: Union[str, np.ndarray, float, int]) -> str:
        if isinstance(x, str):
            return x
        return self.const(np.asarray(x))

    # -- graph I/O ----------------------------------------------------------

    def input(self, name: str, dtype: np.dtype, shape: Sequence) -> str:
        self.inputs.append(_value_info(name, P.onnx_dtype(dtype), shape))
        return name

    def output(self, name: str, dtype: np.dtype, shape: Sequence) -> None:
        self.outputs.append(_value_info(name, P.onnx_dtype(dtype), shape))

    # -- generic node -------------------------------------------------------

    def op(self, op_type: str, *inputs, outputs: int = 1,
           out: Optional[str] = None, **attrs):
        ins = [self._name(i) if i is not None else "" for i in inputs]
        if outputs == 1:
            outs = [out or self.fresh(op_type.lower())]
        else:
            outs = [self.fresh(op_type.lower()) for _ in range(outputs)]
        self.nodes.append(P.make_node(op_type, ins, outs, **attrs))
        return outs[0] if outputs == 1 else tuple(outs)

    # -- arithmetic sugar ---------------------------------------------------

    def add(self, a, b):
        return self.op("Add", a, b)

    def sub(self, a, b):
        return self.op("Sub", a, b)

    def mul(self, a, b):
        return self.op("Mul", a, b)

    def div(self, a, b):
        return self.op("Div", a, b)

    def matmul(self, a, b):
        return self.op("MatMul", a, b)

    def reshape(self, x, shape: Sequence[int]):
        return self.op("Reshape", x, np.asarray(shape, I64))

    def transpose(self, x, perm: Sequence[int]):
        return self.op("Transpose", x, perm=list(perm))

    def concat(self, xs: Sequence, axis: int):
        return self.op("Concat", *xs, axis=axis)

    def unsqueeze(self, x, axes: Sequence[int]):
        return self.op("Unsqueeze", x, np.asarray(axes, I64))

    def cast(self, x, to_np_dtype):
        return self.op("Cast", x, to=P.onnx_dtype(to_np_dtype))

    def gather(self, data, indices, axis: int = 0):
        return self.op("Gather", data, indices, axis=axis)

    def slice_(self, x, starts, ends, axes):
        return self.op("Slice", x, np.asarray(starts, I64),
                       np.asarray(ends, I64), np.asarray(axes, I64))

    def shape_dim(self, x, idx: int):
        """Shape(x)[idx] as a scalar int64 tensor."""
        s = self.op("Shape", x)
        return self.op("Gather", s, np.asarray(idx, I64), axis=0)

    # -- NN building blocks (matching models/common.py semantics) ----------

    def weight(self, w: np.ndarray) -> str:
        """A weight constant, int8-quantized + in-graph-dequantized when the
        builder's quantize mode and the program's gate (≥2 dims, >1024
        elements — the matmul/conv weights) say so."""
        w = np.asarray(w, np.float32)
        if self.quantize == "int8" and w.ndim >= 2 \
                and w.size > self.quantize_min_size:
            scale = max(float(np.max(np.abs(w))), 1e-12) / 127.0
            wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
            return self.op("DequantizeLinear", self.const(wq),
                           np.float32(scale))
        return self.const(w)

    def linear(self, x, p: dict):
        """x @ w(in,out) + b (models/common.py:linear)."""
        y = self.matmul(x, self.weight(p["w"]))
        if "b" in p:
            y = self.add(y, np.asarray(p["b"], np.float32))
        return y

    def layer_norm(self, x, p: dict, eps: float = 1e-5):
        return self.op("LayerNormalization",
                       x, np.asarray(p["scale"], np.float32),
                       np.asarray(p["bias"], np.float32),
                       axis=-1, epsilon=float(eps))

    def gelu(self, x):
        """Exact erf GELU: 0.5·x·(1+erf(x/√2)) (models/common.py:gelu)."""
        e = self.op("Erf", self.div(x, np.float32(math.sqrt(2.0))))
        return self.mul(self.mul(x, np.float32(0.5)),
                        self.add(e, np.float32(1.0)))

    def relu(self, x):
        return self.op("Relu", x)

    def softmax(self, x, axis: int = -1):
        return self.op("Softmax", x, axis=axis)

    def mlp(self, x, p: dict):
        """relu-separated MLP head (models/common.py:mlp)."""
        n = len(p["layers"])
        for i, lp in enumerate(p["layers"]):
            x = self.linear(x, lp)
            if i < n - 1:
                x = self.relu(x)
        return x

    def mlp_block_relu(self, x, p: dict):
        return self.linear(self.relu(self.linear(x, p["lin1"])), p["lin2"])

    def conv_nchw(self, x, p: dict, stride: int):
        """NCHW Conv from an HWIO jax kernel (VALID padding)."""
        w = np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))  # OIHW
        ins = [x, self.weight(np.ascontiguousarray(w))]
        if "b" in p:
            ins.append(self.const(np.asarray(p["b"], np.float32)))
        return self.op("Conv", *ins, strides=[stride, stride],
                       pads=[0, 0, 0, 0])

    def conv_transpose_nchw(self, x, p: dict, stride: int):
        """NCHW ConvTranspose from the jax-stored kernel.

        The stored kernel is HWIO *spatially flipped* for jax's
        lax.conv_transpose convention (models/convert._conv_t); ONNX
        ConvTranspose wants the torch (in, out, kH, kW) orientation — unflip
        and permute numpy-side.
        """
        w = np.asarray(p["w"], np.float32)[::-1, ::-1]      # undo flip
        w = np.transpose(w, (2, 3, 0, 1))                   # IOHW
        ins = [x, self.weight(np.ascontiguousarray(w))]
        if "b" in p:
            ins.append(self.const(np.asarray(p["b"], np.float32)))
        return self.op("ConvTranspose", *ins, strides=[stride, stride],
                       pads=[0, 0, 0, 0])

    def layer_norm_2d_nchw(self, x, p: dict, eps: float = 1e-6):
        """Reference LayerNorm2d on NCHW data: normalise the channel axis
        (transpose → last-axis LayerNormalization → transpose back)."""
        xt = self.transpose(x, (0, 2, 3, 1))
        yt = self.layer_norm(xt, p, eps=eps)
        return self.transpose(yt, (0, 3, 1, 2))

    def attention(self, p: dict, q, k, v, num_heads: int, head_dim: int):
        """models/transformer.attention — (B,Nq,C)×(B,Nk,C)² -> (B,Nq,C)."""
        qh = self._split_heads(self.linear(q, p["q_proj"]), num_heads, head_dim)
        kh = self._split_heads(self.linear(k, p["k_proj"]), num_heads, head_dim)
        vh = self._split_heads(self.linear(v, p["v_proj"]), num_heads, head_dim)
        logits = self.matmul(qh, self.transpose(kh, (0, 1, 3, 2)))
        logits = self.div(logits, np.float32(math.sqrt(head_dim)))
        w = self.softmax(logits, axis=-1)
        out = self.matmul(w, vh)                        # (B, nh, Nq, hd)
        out = self.transpose(out, (0, 2, 1, 3))
        out = self.reshape(out, (0, 0, num_heads * head_dim))
        return self.linear(out, p["out_proj"])

    def _split_heads(self, x, nh: int, hd: int):
        x = self.reshape(x, (0, 0, nh, hd))
        return self.transpose(x, (0, 2, 1, 3))

    # -- serialisation ------------------------------------------------------

    def model_bytes(self, opset: int = 17, doc: str = "") -> bytes:
        graph = P.make_graph(self.nodes, self.name, self.inputs, self.outputs,
                             self.initializers)
        return P.make_model(graph, opset=opset, doc=doc)


def _value_info(name: str, elem_type: int, shape: Sequence) -> bytes:
    """ValueInfo supporting int dims (dim_value) and str dims (dim_param)."""
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += P._f_bytes(1, P._f_string(2, d))
        else:
            dims += P._f_bytes(1, P._f_varint(1, int(d)))
    tensor = P._f_varint(1, elem_type) + P._f_bytes(2, dims)
    return P._f_string(1, name) + P._f_bytes(2, P._f_bytes(1, tensor))


# ===========================================================================
# The decoder graph
# ===========================================================================


def _np_params(model) -> dict:
    """The prompt encoder's and mask decoder's weights of a port
    ``SamModel`` as the JAX package's parameter tree of numpy arrays."""
    from samcarriestheburden_torch.models.convert import sam_params_from_state_dict

    sd = {k: v for k, v in model.state_dict().items()
          if k.startswith(("prompt_encoder.", "mask_decoder."))}
    return sam_params_from_state_dict(sd, model.cfg)


def _dense_pe_grid(pe_params: dict, h: int, w: int) -> np.ndarray:
    """get_dense_pe as a numpy constant (models/prompt_encoder.py:64-72)."""
    y = (np.arange(h, dtype=np.float32) + 0.5) / h
    x = (np.arange(w, dtype=np.float32) + 0.5) / w
    gx, gy = np.meshgrid(x, y, indexing="xy")
    coords = 2 * np.stack([gx, gy], axis=-1) - 1
    proj = 2 * np.pi * (coords @ np.asarray(pe_params["pe_gaussian"],
                                            np.float32))
    pe = np.concatenate([np.sin(proj), np.cos(proj)], axis=-1)  # (H, W, C)
    return np.ascontiguousarray(np.transpose(pe, (2, 0, 1))[None])


def build_decoder_graph(model, return_single_mask: bool,
                        use_stability_score: bool = False,
                        return_extra_metrics: bool = False,
                        stability_score_offset: float = 1.0,
                        quantize: Optional[str] = None,
                        quantize_min_size: int = 1024) -> GraphBuilder:
    """Emit the SamOnnxModel-equivalent decoder graph for ``model``
    (a models.sam.SamModel).  Mirrors export.program.make_decoder_fn
    statement-for-statement; tests/test_torch_export.py asserts numeric
    parity between the two on the golden vit_t weights."""
    cfg = model.cfg
    img_size = model.img_size
    params = _np_params(model)
    pe_p, pe_c = params["prompt_encoder"], cfg.prompt_encoder
    md_p, md_c = params["mask_decoder"], cfg.mask_decoder
    ed = pe_c.embed_dim
    eh, ew = pe_c.image_embedding_size
    g4h, g4w = 4 * eh, 4 * ew
    nt = md_c.num_mask_tokens
    td = md_c.transformer_dim
    nh = md_c.transformer_num_heads
    dr = md_c.attention_downsample_rate

    if quantize not in (None, "int8"):
        raise ValueError(f"onnx export supports quantize='int8' only, "
                         f"got {quantize!r}")
    g = GraphBuilder("sam_decoder", quantize=quantize)
    g.quantize_min_size = quantize_min_size  # tests lower it: the tiny
    #                     golden vit_t has no >1024-element weights
    image_embeddings = g.input("image_embeddings", np.float32,
                               (1, td, eh, ew))
    point_coords = g.input("point_coords", np.float32, ("b", "n", 2))
    point_labels = g.input("point_labels", np.float32, ("b", "n"))
    mask_input = g.input("mask_input", np.float32, ("b", 1, g4h, g4w))
    has_mask_input = g.input("has_mask_input", np.float32, ("b",))
    orig_im_size = g.input("orig_im_size", np.int32, (2,))

    # -- sparse embeddings (prompt_encoder.embed_unified_points) ------------
    coords = g.add(point_coords, np.float32(0.5))
    ih, iw = pe_c.input_image_size
    norm = g.div(coords, np.asarray([iw, ih], np.float32))
    proj = g.matmul(g.sub(g.mul(norm, np.float32(2.0)), np.float32(1.0)),
                    np.asarray(pe_p["pe_gaussian"], np.float32))
    proj = g.mul(proj, np.float32(2 * np.pi))
    pe = g.concat([g.op("Sin", proj), g.op("Cos", proj)], axis=-1)
    labels_i = g.cast(point_labels, np.int64)
    type_emb = g.gather(np.asarray(pe_p["point_embeddings"], np.float32),
                        g.op("Clip", labels_i, np.asarray(0, I64),
                             np.asarray(3, I64)), axis=0)
    is_pad = g.unsqueeze(g.op("Equal", labels_i, np.asarray(-1, I64)), [-1])
    sparse = g.op("Where", is_pad,
                  np.asarray(pe_p["not_a_point_embed"][0], np.float32),
                  g.add(pe, type_emb))                       # (B, N, ed)

    # -- dense embeddings (embed_masks_or_default, float mul-blend like the
    #    reference's branch-free SamOnnxModel._embed_masks, onnx.py:70-74) --
    mdp = pe_p["mask_downscaling"]
    x = g.conv_nchw(mask_input, mdp["conv1"], stride=2)
    x = g.gelu(g.layer_norm_2d_nchw(x, mdp["ln1"]))
    x = g.conv_nchw(x, mdp["conv2"], stride=2)
    x = g.gelu(g.layer_norm_2d_nchw(x, mdp["ln2"]))
    masked_dense = g.conv_nchw(x, mdp["conv3"], stride=1)    # (B, ed, eh, ew)
    no_mask = np.ascontiguousarray(
        np.asarray(pe_p["no_mask_embed"], np.float32).reshape(1, ed, 1, 1))
    gate = g.reshape(has_mask_input, (-1, 1, 1, 1))
    dense = g.add(g.mul(masked_dense, gate),
                  g.mul(g.const(no_mask),
                        g.sub(np.float32(1.0), gate)))       # (B, ed, eh, ew)

    image_pe = g.const(_dense_pe_grid(pe_p, eh, ew), "image_pe")

    # -- mask_decoder.predict_masks -----------------------------------------
    output_tokens = np.concatenate(
        [np.asarray(md_p["iou_token"], np.float32),
         np.asarray(md_p["mask_tokens"], np.float32)], axis=0)  # (1+nt, td)
    bdim = g.shape_dim(sparse, 0)                             # scalar int64
    tok_shape = g.concat([g.unsqueeze(bdim, [0]),
                          g.const(np.asarray([1 + nt, td], I64))], axis=0)
    tokens0 = g.op("Expand", g.const(output_tokens[None]), tok_shape)
    tokens = g.concat([tokens0, sparse], axis=1)              # (B, T, td)

    src = g.add(image_embeddings, dense)                      # (B, td, eh, ew)
    keys = g.transpose(g.reshape(src, (0, td, eh * ew)), (0, 2, 1))
    key_pe1 = g.transpose(g.reshape(image_pe, (1, td, eh * ew)), (0, 2, 1))

    hd, hd_x = td // nh, (td // dr) // nh
    queries = tokens
    for i, layer in enumerate(md_p["transformer"]["layers"]):
        # TwoWayAttentionBlock (models/transformer.block_apply)
        if i == 0:  # skip_first_layer_pe
            queries = g.attention(layer["self_attn"], queries, queries,
                                  queries, nh, hd)
        else:
            q = g.add(queries, tokens)
            queries = g.add(queries, g.attention(layer["self_attn"], q, q,
                                                 queries, nh, hd))
        queries = g.layer_norm(queries, layer["norm1"])

        q = g.add(queries, tokens)
        k = g.add(keys, key_pe1)
        queries = g.add(queries, g.attention(
            layer["cross_attn_token_to_image"], q, k, keys, nh, hd_x))
        queries = g.layer_norm(queries, layer["norm2"])

        queries = g.add(queries, g.mlp_block_relu(queries, layer["mlp"]))
        queries = g.layer_norm(queries, layer["norm3"])

        q = g.add(queries, tokens)
        k = g.add(keys, key_pe1)
        keys = g.add(keys, g.attention(
            layer["cross_attn_image_to_token"], k, q, queries, nh, hd_x))
        keys = g.layer_norm(keys, layer["norm4"])

    q = g.add(queries, tokens)
    k = g.add(keys, key_pe1)
    queries = g.add(queries, g.attention(
        md_p["transformer"]["final_attn_token_to_image"], q, k, keys, nh,
        hd_x))
    hs = g.layer_norm(queries, md_p["transformer"]["norm_final_attn"])

    iou_token_out = g.reshape(g.slice_(hs, [0], [1], [1]), (0, td))
    # stacked hypernetwork MLPs, unrolled over the static token axis
    hyper_rows = []
    hyper = md_p["output_hypernetworks_mlps"]
    for t in range(nt):
        tok = g.reshape(g.slice_(hs, [1 + t], [2 + t], [1]), (0, td))
        p_t = {"layers": [{k2: np.asarray(v2[t]) for k2, v2 in lp.items()}
                          for lp in hyper["layers"]]}
        hyper_rows.append(g.unsqueeze(g.mlp(tok, p_t), [1]))
    hyper_in = g.concat(hyper_rows, axis=1)                   # (B, nt, td//8)

    # output upscaling, reference structure (mask_decoder.py:53-59,137-148)
    up = md_p["output_upscaling"]
    src_img = g.reshape(g.transpose(keys, (0, 2, 1)), (0, td, eh, ew))
    u = g.conv_transpose_nchw(src_img, up["up1"], stride=2)
    u = g.gelu(g.layer_norm_2d_nchw(u, up["ln"]))
    u = g.gelu(g.conv_transpose_nchw(u, up["up2"], stride=2))  # (B,td/8,4eh,4ew)
    u_flat = g.reshape(u, (0, td // 8, g4h * g4w))
    masks = g.reshape(g.matmul(hyper_in, u_flat), (0, nt, g4h, g4w))
    scores = g.mlp(iou_token_out, md_p["iou_prediction_head"])  # (B, nt)

    if use_stability_score:
        scores = _stability_score(g, masks, cfg.mask_threshold,
                                  stability_score_offset)

    if return_single_mask:
        n_pts = g.cast(g.shape_dim(point_coords, 1), np.float32)
        reweight = np.zeros((1, nt), np.float32)
        reweight[0, 0] = 1000.0
        score = g.add(scores, g.mul(g.sub(n_pts, np.float32(2.5)),
                                    g.const(reweight)))
        best = g.op("ArgMax", score, axis=1, keepdims=1)      # (B, 1) int64
        masks = g.unsqueeze(
            g.op("GatherND", masks, best, batch_dims=1), [1])  # (B, 1, h, w)
        scores = g.op("GatherND", scores, best, batch_dims=1)
        scores = g.unsqueeze(scores, [1])                     # (B, 1)
        k_out = 1
    else:
        k_out = nt

    upscaled = g.op("Resize", masks, None, g.const(np.asarray(
        [1.0, 1.0, img_size / g4h, img_size / g4w], np.float32)),
        mode="linear", coordinate_transformation_mode="half_pixel",
        out="masks")
    prepadded = _resize_longest(g, orig_im_size, img_size)

    g.output("masks", np.float32, ("b", k_out, img_size, img_size))
    g.output("prepadded_size", np.int32, (2,))
    g.op("Identity", scores, out="iou_predictions")
    g.output("iou_predictions", np.float32, ("b", k_out))
    g.op("Identity", masks, out="low_res_masks")
    g.output("low_res_masks", np.float32, ("b", k_out, g4h, g4w))

    if return_extra_metrics:
        stab = _stability_score(g, upscaled, cfg.mask_threshold,
                                stability_score_offset, out="stability_scores")
        g.output("stability_scores", np.float32, ("b", k_out))
        areas = g.op("ReduceSum", g.cast(
            g.op("Greater", upscaled, np.float32(cfg.mask_threshold)),
            np.float32), np.asarray([-1, -2], I64), keepdims=0, out="areas")
        g.output("areas", np.float32, ("b", k_out))
    return g


def _stability_score(g: GraphBuilder, masks, thr: float, offset: float,
                     out: Optional[str] = None):
    """ops/mask_ops.calculate_stability_score as ONNX nodes."""
    axes = np.asarray([-1, -2], I64)
    hi = g.op("ReduceSum",
              g.cast(g.op("Greater", masks, np.float32(thr + offset)),
                     np.float32), axes, keepdims=0)
    lo = g.op("ReduceSum",
              g.cast(g.op("Greater", masks, np.float32(thr - offset)),
                     np.float32), axes, keepdims=0)
    return g.op("Div", hi, lo, out=out) if out else g.div(hi, lo)


def _resize_longest(g: GraphBuilder, orig_im_size, longest: int):
    """export.program.resize_longest_image_size as ONNX nodes."""
    size_f = g.cast(orig_im_size, np.float32)
    scale = g.div(np.float32(float(longest)),
                  g.op("ReduceMax", size_f, keepdims=0))
    scaled = g.add(g.mul(size_f, scale), np.float32(0.5))
    return g.op("Cast", g.op("Floor", scaled), to=P.onnx_dtype(np.int32),
                out="prepadded_size")


def export_decoder_onnx(model, out_path, *, return_single_mask: bool,
                        use_stability_score: bool = False,
                        return_extra_metrics: bool = False,
                        quantize: Optional[str] = None,
                        opset: int = 17):
    """Write a consumable ``.onnx`` decoder artifact (the analogue of
    reference scripts/export_onnx_model.py:122-159; ``quantize='int8'``
    mirrors its optional uint8 quantize_dynamic step, :187-201)."""
    from pathlib import Path

    g = build_decoder_graph(model, return_single_mask, use_stability_score,
                            return_extra_metrics, quantize=quantize)
    data = g.model_bytes(opset=opset,
                         doc="SAM decoder (SamOnnxModel semantics)")
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_bytes(data)
    return out_path
