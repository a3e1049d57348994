"""Dependency-free ONNX protobuf wire-format codec.

The reference emits a real ``.onnx`` artifact through the ``onnx`` python
package (reference scripts/export_onnx_model.py:122-159).  This build
environment has neither ``onnx`` nor ``onnxruntime``, so interchange is
implemented from first principles: this module encodes/decodes the subset of
the ONNX protobuf schema (ModelProto / GraphProto / NodeProto / TensorProto /
ValueInfoProto / AttributeProto) directly at the protobuf *wire-format* level.

Consumers: :mod:`export.onnx_graph` builds the SAM decoder graph on these
primitives (``cli/export_decoder --format onnx``), and
:mod:`export.onnx_eval` interprets parsed graphs.  The field-number tables
below are validated in tests/test_onnx_export.py by round-tripping a model
produced by torch's own C++ ONNX serializer (``graph._export_onnx``) through
:func:`parse_model` — i.e. the schema constants are checked against an
independent, battle-tested producer, not just against this module's own
writer.

Wire format refresher (https://protobuf.dev/programming-guides/encoding):
every field is ``(field_no << 3 | wire_type)`` varint key, then a payload:
wire 0 = varint, 1 = fixed64, 2 = length-delimited, 5 = fixed32.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------------
# TensorProto.DataType enum (onnx.proto3; stable since IR v3)
# --------------------------------------------------------------------------
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL = range(1, 10)
FLOAT16, DOUBLE, UINT32, UINT64 = 10, 11, 12, 13
BFLOAT16 = 16

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.uint16): UINT16,
    np.dtype(np.int16): INT16,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.uint32): UINT32,
    np.dtype(np.uint64): UINT64,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}

# AttributeProto.AttributeType enum
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_TENSOR = 1, 2, 3, 4
_ATTR_FLOATS, _ATTR_INTS, _ATTR_STRINGS = 6, 7, 8


def onnx_dtype(np_dtype) -> int:
    """numpy dtype -> TensorProto.DataType enum value."""
    dt = np.dtype(np_dtype)
    if dt not in _NP_TO_ONNX:
        raise ValueError(f"no ONNX dtype for numpy {dt}")
    return _NP_TO_ONNX[dt]


def numpy_dtype(onnx_enum: int) -> np.dtype:
    """TensorProto.DataType enum -> numpy dtype."""
    if onnx_enum not in _ONNX_TO_NP:
        raise ValueError(f"unsupported ONNX data_type {onnx_enum}")
    return _ONNX_TO_NP[onnx_enum]


# --------------------------------------------------------------------------
# Low-level writers
# --------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:  # protobuf encodes negative int64 as 10-byte two's complement
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _f_string(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode("utf-8"))


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


# --------------------------------------------------------------------------
# Message builders (field numbers per onnx.proto3, empirically validated)
# --------------------------------------------------------------------------

def make_tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    shape = np.asarray(array).shape  # before ascontiguousarray: it promotes
    arr = np.ascontiguousarray(array)  # 0-d arrays to 1-d
    out = b"".join(_f_varint(1, int(d)) for d in shape)
    out += _f_varint(2, onnx_dtype(arr.dtype))
    if name:
        out += _f_string(8, name)
    # raw_data is little-endian; bool is one byte per element
    data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
    out += _f_bytes(9, data)
    return out


def make_attribute(name: str, value: Any) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    strings=9, type=20."""
    out = _f_string(1, name)
    if isinstance(value, bool):
        out += _f_varint(3, int(value)) + _f_varint(20, _ATTR_INT)
    elif isinstance(value, int):
        out += _f_varint(3, value) + _f_varint(20, _ATTR_INT)
    elif isinstance(value, float):
        out += _f_float(2, value) + _f_varint(20, _ATTR_FLOAT)
    elif isinstance(value, str):
        out += _f_bytes(4, value.encode("utf-8")) + _f_varint(20, _ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += _f_bytes(5, make_tensor("", value)) + _f_varint(20, _ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            out += b"".join(_f_varint(8, v) for v in value)
            out += _f_varint(20, _ATTR_INTS)
        elif all(isinstance(v, float) for v in value):
            out += b"".join(_f_float(7, v) for v in value)
            out += _f_varint(20, _ATTR_FLOATS)
        elif all(isinstance(v, str) for v in value):
            out += b"".join(_f_bytes(9, v.encode("utf-8")) for v in value)
            out += _f_varint(20, _ATTR_STRINGS)
        else:
            raise TypeError(f"mixed attribute list for {name!r}")
    else:
        raise TypeError(f"unsupported attribute type {type(value)} for {name!r}")
    return out


def make_node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
              name: str = "", **attrs: Any) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b"".join(_f_string(1, i) for i in inputs)
    out += b"".join(_f_string(2, o) for o in outputs)
    if name:
        out += _f_string(3, name)
    out += _f_string(4, op_type)
    for k, v in attrs.items():
        out += _f_bytes(5, make_attribute(k, v))
    return out


def make_value_info(name: str, elem_type: int, shape: Sequence[int]) -> bytes:
    """ValueInfoProto{name=1, type=2} / TypeProto{tensor_type=1} /
    TypeProto.Tensor{elem_type=1, shape=2} / TensorShapeProto{dim=1} /
    Dimension{dim_value=1}."""
    dims = b"".join(_f_bytes(1, _f_varint(1, int(d))) for d in shape)
    tensor = _f_varint(1, elem_type) + _f_bytes(2, dims)
    type_proto = _f_bytes(1, tensor)
    return _f_string(1, name) + _f_bytes(2, type_proto)


def make_graph(nodes: Sequence[bytes], name: str, inputs: Sequence[bytes],
               outputs: Sequence[bytes],
               initializers: Sequence[bytes] = ()) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    out = b"".join(_f_bytes(1, n) for n in nodes)
    out += _f_string(2, name)
    out += b"".join(_f_bytes(5, t) for t in initializers)
    out += b"".join(_f_bytes(11, v) for v in inputs)
    out += b"".join(_f_bytes(12, v) for v in outputs)
    return out


def make_model(graph: bytes, opset: int = 17,
               producer: str = "samcarriestheburden-tpu",
               doc: str = "") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, producer_version=3,
    doc_string=6, graph=7, opset_import=8 (OperatorSetId{domain=1,
    version=2}).  IR version 8 pairs with opsets 15-18."""
    out = _f_varint(1, 8)
    out += _f_string(2, producer)
    out += _f_string(3, "0")
    if doc:
        out += _f_string(6, doc)
    out += _f_bytes(7, graph)
    out += _f_bytes(8, _f_varint(2, opset))  # default ("" / ai.onnx) domain
    return out


# --------------------------------------------------------------------------
# Generic wire-format reader + typed ONNX views
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    r = s = 0
    while True:
        b = buf[i]
        i += 1
        r |= (b & 0x7F) << s
        s += 7
        if not b & 0x80:
            return r, i


def parse_fields(buf: bytes) -> List[Tuple[int, int, Any]]:
    """Decode a message into raw (field_no, wire_type, value) triples."""
    i, out = 0, []
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v = struct.unpack_from("<d", buf, i)[0]
            i += 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v = buf[i:i + n]
            i += n
        elif wire == 5:
            v = struct.unpack_from("<f", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.append((field, wire, v))
    return out


def _group(buf: bytes) -> Dict[int, List[Any]]:
    g: Dict[int, List[Any]] = {}
    for f, _, v in parse_fields(buf):
        g.setdefault(f, []).append(v)
    return g


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    g = _group(buf)
    dims = _repeated_varints(buf, 1)
    dtype = numpy_dtype(int(g[2][0]))
    name = g.get(8, [b""])[0].decode("utf-8")
    if 9 in g:  # raw_data
        arr = np.frombuffer(g[9][0], dtype=dtype.newbyteorder("<"))
    elif 4 in g and dtype == np.float32:  # float_data (packed or repeated)
        vals: List[float] = []
        for f, w, v in parse_fields(buf):
            if f != 4:
                continue
            if w == 5:
                vals.append(v)
            else:  # packed
                vals.extend(struct.unpack(f"<{len(v) // 4}f", v))
        arr = np.asarray(vals, np.float32)
    elif 7 in g and dtype == np.int64:  # int64_data
        vals = []
        for f, w, v in parse_fields(buf):
            if f != 7:
                continue
            if w == 0:
                vals.append(v)
            else:
                j = 0
                while j < len(v):
                    x, j = _read_varint(v, j)
                    vals.append(x)
        arr = np.asarray(
            [x - (1 << 64) if x >= 1 << 63 else x for x in vals], np.int64)
    else:
        arr = np.zeros(dims, dtype)
    return name, arr.reshape(dims).astype(dtype, copy=False)


def _signed64(v: int) -> int:
    v = int(v)
    return v - (1 << 64) if v >= 1 << 63 else v


def _repeated_varints(buf: bytes, field: int) -> List[int]:
    """Collect a repeated varint field, whether packed (wire 2) or not."""
    vals: List[int] = []
    for f, w, v in parse_fields(buf):
        if f != field:
            continue
        if w == 0:
            vals.append(_signed64(v))
        else:  # packed
            j = 0
            while j < len(v):
                x, j = _read_varint(v, j)
                vals.append(_signed64(x))
    return vals


def _parse_attr(buf: bytes) -> Tuple[str, Any]:
    g = _group(buf)
    name = g[1][0].decode("utf-8")
    if 5 in g:  # t
        return name, parse_tensor(g[5][0])[1]
    if 8 in g:  # ints (possibly packed)
        return name, _repeated_varints(buf, 8)
    if 3 in g:  # i
        return name, _signed64(g[3][0])
    if 2 in g:  # f
        return name, float(g[2][0])
    if 7 in g:  # floats (possibly packed)
        vals: List[float] = []
        for f, w, v in parse_fields(buf):
            if f != 7:
                continue
            if w == 5:
                vals.append(float(v))
            else:  # packed fixed32s
                vals.extend(struct.unpack(f"<{len(v) // 4}f", v))
        return name, vals
    if 4 in g:  # s
        return name, g[4][0].decode("utf-8")
    if 9 in g:  # strings
        return name, [v.decode("utf-8") for v in g[9]]
    return name, None


def _parse_value_info(buf: bytes) -> Dict[str, Any]:
    g = _group(buf)
    out: Dict[str, Any] = {"name": g[1][0].decode("utf-8"),
                           "elem_type": None, "shape": None}
    if 2 in g:
        tg = _group(g[2][0])
        if 1 in tg:  # tensor_type
            tt = _group(tg[1][0])
            out["elem_type"] = int(tt[1][0]) if 1 in tt else None
            if 2 in tt:
                dims = []
                for d in _group(tt[2][0]).get(1, []):
                    dg = _group(d)
                    dims.append(int(dg[1][0]) if 1 in dg
                                else dg.get(2, [b"?"])[0].decode("utf-8"))
                out["shape"] = dims
    return out


def _parse_node(buf: bytes) -> Dict[str, Any]:
    g = _group(buf)
    return {
        "input": [v.decode("utf-8") for v in g.get(1, [])],
        "output": [v.decode("utf-8") for v in g.get(2, [])],
        "name": g.get(3, [b""])[0].decode("utf-8"),
        "op_type": g[4][0].decode("utf-8"),
        "attrs": dict(_parse_attr(a) for a in g.get(5, [])),
    }


def parse_graph(buf: bytes) -> Dict[str, Any]:
    g = _group(buf)
    return {
        "name": g.get(2, [b""])[0].decode("utf-8"),
        "nodes": [_parse_node(n) for n in g.get(1, [])],
        "initializers": dict(parse_tensor(t) for t in g.get(5, [])),
        "inputs": [_parse_value_info(v) for v in g.get(11, [])],
        "outputs": [_parse_value_info(v) for v in g.get(12, [])],
    }


def parse_model(buf: bytes) -> Dict[str, Any]:
    """Decode ModelProto bytes into a python dict tree (graph subset)."""
    g = _group(buf)
    opsets = []
    for o in g.get(8, []):
        og = _group(o)
        opsets.append((og.get(1, [b""])[0].decode("utf-8"),
                       int(og.get(2, [0])[0])))
    return {
        "ir_version": int(g.get(1, [0])[0]),
        "producer_name": g.get(2, [b""])[0].decode("utf-8"),
        "opset_import": opsets,
        "graph": parse_graph(g[7][0]),
    }
