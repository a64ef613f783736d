"""The flax ``msgpack`` format of the JAX package's weight files, with ``struct``,
numpy and torch alone.

The JAX package writes its weights with ``flax.serialization.to_bytes`` (its
``save_params``, its launcher's ``geometry.msgpack`` and its
``tools/convert_checkpoints.py``) and reads them with ``from_bytes``. That format is
msgpack with three extension types:

* ext 1, an array: the msgpack of ``(shape, dtype name, C-order bytes)``;
* ext 2, a Python complex: the msgpack of ``(real, imag)``;
* ext 3, a numpy scalar: an ext 1 payload of shape ``()``;

and a leaf over :data:`MAX_CHUNK_SIZE` bytes becomes the dict
``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0": ..}}`` of
its flattened pieces. :func:`dumps` writes the bytes ``to_bytes`` writes for a tree of
dicts (str keys, in their order), arrays (numpy or torch) and Python scalars: the
smallest int, string, binary, array, map and ext forms, strings as str8 and bytes as
bin (``use_bin_type``), floats as float64. :func:`loads` reads any of it; arrays
come back as numpy arrays, but ``bfloat16``, which numpy lacks, comes back as a
``torch.bfloat16`` tensor. :func:`dump` and :func:`load` do the same on a file
without holding a second copy of the arrays.
"""

from __future__ import annotations

import io
import struct
from typing import Any, BinaryIO, Dict, List, Mapping, Tuple

import numpy as np
import torch

# flax's limit on the bytes of one leaf before it is chunked (msgpack's is 2**31 - 1)
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# -- encoding -------------------------------------------------------------------------


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if n > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000), (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} does not fit in 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> bytes:
    """The header of a str, bin, array or map of ``n`` items: the fix form when
    ``fix`` and ``n <= fix_max``, else the 8- (where ``codes`` has one), 16- or 32-bit
    length form."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    widths = ((">B", 0xFF), (">H", 0xFFFF), (">I", 0xFFFFFFFF))[3 - len(codes):]
    for code, (fmt, top) in zip(codes, widths):
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} items do not fit in msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, -1, (0xC4, 0xC5, 0xC6))


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 15, (0xDC, 0xDD))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 15, (0xDE, 0xDF))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    for head, fmt, top in ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF)):
        if n <= top:
            return bytes([head]) + struct.pack(fmt, n) + bytes([code])
    raise OverflowError(f"an ext of {n} bytes does not fit in msgpack")


def _float(x: float) -> bytes:
    return b"\xcb" + struct.pack(">d", x)


def _array_parts(x) -> Tuple[Tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of a numpy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: the bits as int16
            return tuple(t.shape), "bfloat16", memoryview(t.view(torch.int16).numpy()
                                                          .reshape(-1).view(np.uint8))
        x = t.numpy()
    arr = np.ascontiguousarray(x)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    return tuple(x.shape), arr.dtype.name, memoryview(arr.reshape(-1).view(np.uint8))


def _ndarray_payload(x) -> List[Any]:
    """The pieces of an ext 1 payload: header bytes, then the data's memoryview."""
    shape, name, data = _array_parts(x)
    head = _array_header(3) + _array_header(len(shape)) + b"".join(_int(int(d)) for d in shape)
    return [head + _str(name) + _bin_header(data.nbytes), data]


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunked(x) -> Dict[str, Any]:
    """flax's ``_chunk``: a leaf's flattened pieces of at most MAX_CHUNK_SIZE bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _encode(obj, out: BinaryIO) -> None:
    if obj is None:
        out.write(b"\xc0")
    elif obj is True or obj is False:
        out.write(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.write(_int(obj))
    elif type(obj) is float:
        out.write(_float(obj))
    elif type(obj) is str:
        out.write(_str(obj))
    elif type(obj) is bytes:
        out.write(_bin_header(len(obj)) + obj)
    elif isinstance(obj, Mapping):
        out.write(_map_header(len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys are str, got {type(k).__name__}")
            out.write(_str(k))
            _encode(_chunked(v) if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE else v, out)
    elif isinstance(obj, (list, tuple)):
        out.write(_array_header(len(obj)))
        for v in obj:
            _encode(v, out)
    elif _is_array(obj):
        head, data = _ndarray_payload(obj)
        out.write(_ext_header(_EXT_NDARRAY, len(head) + data.nbytes) + head)
        out.write(data)
    elif isinstance(obj, np.generic):
        head, data = _ndarray_payload(np.asarray(obj))
        out.write(_ext_header(_EXT_NPSCALAR, len(head) + data.nbytes) + head + bytes(data))
    elif type(obj) is complex:
        payload = _array_header(2) + _float(obj.real) + _float(obj.imag)
        out.write(_ext_header(_EXT_COMPLEX, len(payload)) + payload)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def dump(tree: Any, f: BinaryIO) -> None:
    """Write ``tree`` to the binary file ``f`` as ``flax.serialization.to_bytes``
    would: a top-level array over MAX_CHUNK_SIZE bytes is chunked as a map's would be."""
    _encode(_chunked(tree) if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE else tree, f)


def dumps(tree: Any) -> bytes:
    """The bytes of :func:`dump`."""
    buf = io.BytesIO()
    dump(tree, buf)
    return buf.getvalue()


# -- decoding -------------------------------------------------------------------------


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False):
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I"}
        if b in lengths:
            n = self.unpack(lengths[b])
            if b <= 0xC6:  # bin: a view inside an array's payload, else bytes
                return self.take(n) if raw else bytes(self.take(n))
            if b <= 0xC9:
                return self.ext(self.unpack("b"), n)
            if b <= 0xDB:
                return self.str(n, raw)
            if b <= 0xDD:
                return [self.obj(raw) for _ in range(n)]
            return self.map(n, raw)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack("b"), fixext[b])
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack object")

    def str(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def map(self, n: int, raw: bool) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def ext(self, code: int, n: int):
        end = self.pos + n
        if code == _EXT_NDARRAY:
            out = _ndarray(self)
        elif code == _EXT_COMPLEX:
            re, im = self.obj()
            out = complex(re, im)
        elif code == _EXT_NPSCALAR:
            arr = _ndarray(self)
            out = arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        else:
            raise ValueError(f"msgpack ext type {code} is not one flax writes")
        if self.pos != end:
            raise ValueError(f"ext {code} payload of {n} bytes read to {self.pos - end + n}")
        return out


def _ndarray(r: _Reader):
    shape, name, data = r.obj(raw=True)
    name = name.decode("ascii")
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        bits = np.frombuffer(data, dtype=np.uint16)
        if not bits.flags.writeable:
            bits = bits.copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place`` (on dicts, in place)."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        for k, v in tree.items():
            tree[k] = _unchunk(v)
    return tree


def loads(data) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` returns for ``data``
    (bytes, or a writable buffer whose arrays are then views into it): dicts, lists,
    Python scalars, numpy arrays and scalars; ``bfloat16`` arrays as
    ``torch.bfloat16`` tensors."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)


def load(f: BinaryIO) -> Any:
    """:func:`loads` of a binary file's contents, read once into a writable buffer that
    the returned arrays are views of."""
    f.seek(0, io.SEEK_END)
    size = f.tell()
    f.seek(0)
    buf = bytearray(size)
    if f.readinto(buf) != size:
        raise ValueError("short read")
    return loads(buf)
