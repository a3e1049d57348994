"""Reference numpy evaluator for ONNX graphs.

The validation runtime behind ``cli/export_decoder --format onnx`` — the
analogue of the reference's onnxruntime round-trip check
(reference scripts/export_onnx_model.py:161-167), which this environment
cannot run (no onnxruntime).  Interprets the op subset emitted by
:mod:`export.onnx_graph` plus the handful of extra ops torch's own exporter
produces for small models (Gemm/Pow/Sqrt/ReduceMean/Constant), so the same
evaluator cross-checks graphs from an independent producer in
tests/test_onnx_export.py.

Scope: single-output ops, opset-17 semantics for exactly the attributes the
emitter uses.  Unknown ops raise — this is a validator, not a runtime.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from samcarriestheburden_torch.export.onnx_proto import numpy_dtype, parse_model


def _reshape(x: np.ndarray, shape: np.ndarray) -> np.ndarray:
    out = []
    for i, d in enumerate(shape.tolist()):
        out.append(x.shape[i] if d == 0 else int(d))
    return x.reshape(out)


def _softmax(x: np.ndarray, axis: int) -> np.ndarray:
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


def _layer_norm(x, scale, bias, axis: int, eps: float):
    mean = np.mean(x, axis=axis, keepdims=True)
    var = np.mean(np.square(x - mean), axis=axis, keepdims=True)
    return ((x - mean) / np.sqrt(var + eps)) * scale + bias


def _erf(x: np.ndarray) -> np.ndarray:
    try:
        from scipy.special import erf as _serf
        return _serf(x)
    except ImportError:  # vectorised math.erf fallback
        import math
        return np.vectorize(math.erf, otypes=[x.dtype])(x)


def _conv(x, w, b, strides, pads):
    if any(pads):
        ph0, pw0, ph1, pw1 = pads
        x = np.pad(x, ((0, 0), (0, 0), (ph0, ph1), (pw0, pw1)))
    kh, kw = w.shape[2], w.shape[3]
    sh, sw = strides
    oh = (x.shape[2] - kh) // sh + 1
    ow = (x.shape[3] - kw) // sw + 1
    y = np.zeros((x.shape[0], w.shape[0], oh, ow), x.dtype)
    for ki in range(kh):
        for kj in range(kw):
            patch = x[:, :, ki:ki + oh * sh:sh, kj:kj + ow * sw:sw]
            y += np.einsum("nchw,oc->nohw", patch, w[:, :, ki, kj])
    if b is not None:
        y += b[None, :, None, None]
    return y


def _conv_transpose(x, w, b, strides, pads):
    # w: (C_in, C_out, kH, kW); supports the emitter's k == stride, pads 0
    assert not any(pads), "evaluator supports pads=0 ConvTranspose only"
    kh, kw = w.shape[2], w.shape[3]
    sh, sw = strides
    n, c, h, ww_ = x.shape
    oh, ow = (h - 1) * sh + kh, (ww_ - 1) * sw + kw
    y = np.zeros((n, w.shape[1], oh, ow), x.dtype)
    for ki in range(kh):
        for kj in range(kw):
            y[:, :, ki::sh, kj::sw][:, :, :h, :ww_] += np.einsum(
                "nchw,co->nohw", x, w[:, :, ki, kj])
    if b is not None:
        y += b[None, :, None, None]
    return y


def _resize_linear_half_pixel(x, scales):
    """Bilinear resize of the last two axes, half_pixel mode (no antialias —
    matches jax.image.resize 'linear' for upscaling)."""
    assert scales[0] == scales[1] == 1.0, "evaluator resizes spatial axes only"

    def axis_resize(arr, axis, scale):
        n_in = arr.shape[axis]
        n_out = int(round(n_in * scale))
        src = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
        lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
        hi = np.clip(lo + 1, 0, n_in - 1)
        frac = np.clip(src - np.floor(src), 0.0, 1.0)
        frac = np.where(src < 0, 0.0, np.where(src > n_in - 1, 0.0, frac))
        a = np.take(arr, lo, axis=axis)
        b = np.take(arr, hi, axis=axis)
        shape = [1] * arr.ndim
        shape[axis] = n_out
        f = frac.reshape(shape)
        return (a * (1 - f) + b * f).astype(arr.dtype)

    x = axis_resize(x, x.ndim - 2, scales[2])
    return axis_resize(x, x.ndim - 1, scales[3])


def _gather_nd(data, indices, batch_dims: int):
    assert batch_dims == 1, "evaluator supports batch_dims=1"
    out = []
    for b in range(data.shape[0]):
        idx = indices[b]
        flat = idx.reshape(-1, idx.shape[-1])
        rows = [data[b][tuple(r.tolist())] for r in flat]
        out.append(np.stack(rows).reshape(
            idx.shape[:-1] + rows[0].shape if rows else idx.shape[:-1]))
    return np.stack(out)


def _slice(x, starts, ends, axes, steps=None):
    sl = [slice(None)] * x.ndim
    steps = steps if steps is not None else [1] * len(starts)
    for s, e, a, st in zip(starts, ends, axes, steps):
        sl[int(a)] = slice(int(s), None if int(e) >= 2 ** 62 else int(e),
                           int(st))
    return x[tuple(sl)]


def evaluate_graph(graph: Dict, feeds: Dict[str, np.ndarray],
                   outputs: Sequence[str] = None) -> Dict[str, np.ndarray]:
    """Run a parsed GraphProto dict (from onnx_proto.parse_graph) on numpy
    feeds; returns {output_name: value}."""
    env: Dict[str, np.ndarray] = dict(graph["initializers"])
    env.update({k: np.asarray(v) for k, v in feeds.items()})
    want = [o["name"] for o in graph["outputs"]] if outputs is None \
        else list(outputs)

    for node in graph["nodes"]:
        op = node["op_type"]
        ins = [env[i] if i else None for i in node["input"]]
        at = node["attrs"]
        x = ins[0] if ins else None
        if op == "Add":
            r = ins[0] + ins[1]
        elif op == "Sub":
            r = ins[0] - ins[1]
        elif op == "Mul":
            r = ins[0] * ins[1]
        elif op == "Div":
            r = ins[0] / ins[1]
        elif op == "MatMul":
            r = ins[0] @ ins[1]
        elif op == "Gemm":
            a, b = ins[0], ins[1]
            if at.get("transA"):
                a = a.T
            if at.get("transB"):
                b = b.T
            r = at.get("alpha", 1.0) * (a @ b)
            if len(ins) > 2 and ins[2] is not None:
                r = r + at.get("beta", 1.0) * ins[2]
        elif op == "Sin":
            r = np.sin(x)
        elif op == "Cos":
            r = np.cos(x)
        elif op == "Erf":
            r = _erf(x)
        elif op == "Sqrt":
            r = np.sqrt(x)
        elif op == "Pow":
            r = np.power(ins[0], ins[1])
        elif op == "Floor":
            r = np.floor(x)
        elif op == "Relu":
            r = np.maximum(x, 0)
        elif op == "Sigmoid":
            r = 1.0 / (1.0 + np.exp(-x))
        elif op == "Softmax":
            r = _softmax(x, int(at.get("axis", -1)))
        elif op == "LayerNormalization":
            r = _layer_norm(ins[0], ins[1], ins[2],
                            int(at.get("axis", -1)),
                            float(at.get("epsilon", 1e-5)))
        elif op == "ReduceMean":
            axes = at.get("axes")
            if axes is None and len(ins) > 1 and ins[1] is not None:
                axes = ins[1].tolist()
            r = np.mean(x, axis=tuple(axes), keepdims=bool(at.get("keepdims", 1)))
        elif op == "ReduceMax":
            axes = at.get("axes")
            if axes is None and len(ins) > 1 and ins[1] is not None:
                axes = ins[1].tolist()
            axes = tuple(axes) if axes is not None else None
            r = np.max(x, axis=axes, keepdims=bool(at.get("keepdims", 1)))
        elif op == "ReduceSum":
            axes = tuple(ins[1].tolist()) if len(ins) > 1 and ins[1] is not None \
                else tuple(at.get("axes", ()))
            r = np.sum(x, axis=axes or None,
                       keepdims=bool(at.get("keepdims", 1)))
        elif op == "Transpose":
            r = np.transpose(x, at["perm"])
        elif op == "Reshape":
            r = _reshape(x, ins[1])
        elif op == "Concat":
            r = np.concatenate(ins, axis=int(at["axis"]))
        elif op == "Unsqueeze":
            axes = ins[1].tolist() if len(ins) > 1 else at["axes"]
            r = x
            for a in sorted(int(a) % (x.ndim + len(axes)) for a in axes):
                r = np.expand_dims(r, a)
        elif op == "Shape":
            r = np.asarray(x.shape, np.int64)
        elif op == "Expand":
            r = x * np.ones(tuple(ins[1].tolist()), x.dtype) \
                if x.dtype != np.bool_ else np.broadcast_to(
                    x, tuple(ins[1].tolist())).copy()
        elif op == "Cast":
            r = x.astype(numpy_dtype(int(at["to"])))
        elif op == "Clip":
            r = np.clip(x, ins[1], ins[2])
        elif op == "Equal":
            r = ins[0] == ins[1]
        elif op == "Greater":
            r = ins[0] > ins[1]
        elif op == "Where":
            r = np.where(ins[0], ins[1], ins[2])
        elif op == "Gather":
            r = np.take(ins[0], ins[1].astype(np.int64),
                        axis=int(at.get("axis", 0)))
        elif op == "GatherND":
            r = _gather_nd(ins[0], ins[1].astype(np.int64),
                           int(at.get("batch_dims", 0)))
        elif op == "ArgMax":
            r = np.argmax(x, axis=int(at.get("axis", 0))).astype(np.int64)
            if at.get("keepdims", 1):
                r = np.expand_dims(r, int(at.get("axis", 0)))
        elif op == "Slice":
            r = _slice(x, ins[1], ins[2],
                       ins[3] if len(ins) > 3 else range(len(ins[1])),
                       ins[4] if len(ins) > 4 else None)
        elif op == "Conv":
            r = _conv(ins[0], ins[1], ins[2] if len(ins) > 2 else None,
                      at.get("strides", [1, 1]), at.get("pads", [0] * 4))
        elif op == "ConvTranspose":
            r = _conv_transpose(ins[0], ins[1],
                                ins[2] if len(ins) > 2 else None,
                                at.get("strides", [1, 1]),
                                at.get("pads", [0] * 4))
        elif op == "Resize":
            assert at.get("mode") == "linear" and \
                at.get("coordinate_transformation_mode") == "half_pixel", \
                f"unsupported Resize config {at}"
            r = _resize_linear_half_pixel(ins[0], ins[2].tolist())
        elif op == "DequantizeLinear":
            zp = ins[2] if len(ins) > 2 and ins[2] is not None else 0
            r = (x.astype(np.float32) - zp) * ins[1]
        elif op == "Identity":
            r = x
        elif op == "Constant":
            r = at["value"]
        else:
            raise NotImplementedError(f"op {op}")
        env[node["output"][0]] = r

    return {name: env[name] for name in want}


def evaluate_model(model_bytes: bytes, feeds: Dict[str, np.ndarray],
                   outputs: Sequence[str] = None) -> Dict[str, np.ndarray]:
    return evaluate_graph(parse_model(model_bytes)["graph"], feeds, outputs)
