"""Parameter-tree files in flax's msgpack layout, read and written by this
module alone (counterpart of llamole_tpu/utils/serialization.py, which
goes through flax.serialization; neither flax nor msgpack is needed here).

The layout (flax.serialization.msgpack_serialize):

  * dicts are msgpack maps (string keys, written sorted, as a JAX tree
    map leaves them), lists and tuples msgpack arrays, Python scalars
    msgpack scalars
  * an array is ExtType 1 whose payload is the msgpack array
    (shape, dtype name, C-order bytes); a numpy scalar is ExtType 3 with
    the same payload, restored as a 0-d tensor
  * a dict value larger than MAX_CHUNK_SIZE bytes is split into the map
    {"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
    "chunks": {"0": flat piece, ...}}

`save_pytree` streams leaf by leaf to the file (a 2 GB tree never
becomes one bytes object). `load_pytree` reads the file through mmap and
returns the tree with every array as a CPU torch.Tensor; bfloat16 arrays
are read as 16-bit integers and viewed as torch.bfloat16 (no ml_dtypes
needed). `save_state` is flax's to_bytes: the tree goes through flax's
state-dict form first (lists, tuples and namedtuples become maps keyed
"0", "1", ... or by field name; an empty namedtuple such as optax's
EmptyState becomes {}); `load_state` returns that state dict.
"""

import mmap
import os
import struct
from typing import Any, BinaryIO, Tuple

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are written in pieces
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# -- writer ------------------------------------------------------------------

def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes((v,))
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < top:
                return bytes((code,)) + struct.pack(fmt, v)
    for code, fmt, bits in ((0xd0, ">b", 7), (0xd1, ">h", 15),
                            (0xd2, ">i", 31), (0xd3, ">q", 63)):
        if -(1 << bits) <= v:
            return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack")


def _sized(n: int, fix: Tuple[int, int], codes: Tuple[int, ...],
           fmts: Tuple[str, ...]) -> bytes:
    """Header of a str / bin / array / map of length n: the fix form when
    one exists and n fits it, else the smallest 8/16/32-bit form."""
    fix_base, fix_max = fix
    if n < fix_max:
        return bytes((fix_base | n,))
    for code, fmt in zip(codes, fmts):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack object of length {n}")


def _str(s: str) -> bytes:
    raw = s.encode()
    return _sized(len(raw), (0xa0, 32), (0xd9, 0xda, 0xdb),
                  (">B", ">H", ">I")) + raw


def _bin_header(n: int) -> bytes:
    return _sized(n, (0, 0), (0xc4, 0xc5, 0xc6), (">B", ">H", ">I"))


def _array_header(n: int) -> bytes:
    return _sized(n, (0x90, 16), (0xdc, 0xdd), (">H", ">I"))


def _map_header(n: int) -> bytes:
    return _sized(n, (0x80, 16), (0xde, 0xdf), (">H", ">I"))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return bytes((fixed[n], code))
    for head, fmt in ((0xc7, ">B"), (0xc8, ">H"), (0xc9, ">I")):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes((head,)) + struct.pack(fmt, n) + bytes((code,))
    raise OverflowError(f"msgpack ext of length {n}")


def _scalar(v) -> bytes:
    if v is None:
        return b"\xc0"
    if isinstance(v, bool):
        return b"\xc3" if v else b"\xc2"
    if isinstance(v, int):
        return _int(v)
    if isinstance(v, float):
        return b"\xcb" + struct.pack(">d", v)
    if isinstance(v, str):
        return _str(v)
    raise TypeError(f"cannot serialise {type(v).__name__}")


def _host_array(leaf) -> Tuple[Tuple[int, ...], str, np.ndarray]:
    """(shape, dtype name, flat C-order numpy view of the raw bytes)."""
    if isinstance(leaf, torch.Tensor):
        # made contiguous where it lives: a transposed view on the card is
        # laid out there, not by a single host thread
        t = leaf.detach().contiguous().to("cpu")
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy()
        a = t.numpy()
    else:   # np.ascontiguousarray would turn a 0-d array into 1-d
        a = np.asarray(leaf)
        a = a if a.flags.c_contiguous else a.copy(order="C")
    return tuple(a.shape), a.dtype.name, a


def _write_array(f: BinaryIO, leaf, code: int = _EXT_NDARRAY) -> None:
    shape, name, a = _host_array(leaf)
    head = (_array_header(3) + _array_header(len(shape))
            + b"".join(_int(int(d)) for d in shape) + _str(name)
            + _bin_header(a.nbytes))
    f.write(_ext_header(code, len(head) + a.nbytes))
    f.write(head)
    f.write(memoryview(a.reshape(-1).view(np.uint8)))


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return v.nbytes


def _write_chunked(f: BinaryIO, leaf) -> None:
    """flax's _chunk: the flat array in pieces of MAX_CHUNK_SIZE bytes."""
    flat = (leaf.detach().reshape(-1) if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf).reshape(-1))
    itemsize = _nbytes(leaf) // max(flat.shape[0], 1)
    size = max(1, int(MAX_CHUNK_SIZE / max(itemsize, 1)))
    pieces = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    f.write(_map_header(3) + _str(_CHUNKED) + _scalar(True))
    f.write(_str("shape") + _map_header(len(leaf.shape)))
    for i, d in enumerate(leaf.shape):
        f.write(_str(str(i)) + _int(int(d)))
    f.write(_str("chunks") + _map_header(len(pieces)))
    for i, piece in enumerate(pieces):
        f.write(_str(str(i)))
        _write_array(f, piece)


def _write(f: BinaryIO, node, chunk: bool = True,
           sort_keys: bool = True) -> None:
    """flax chunks big arrays reached through dicts alone: never inside a
    list, nor below one. sort_keys: string keys sorted (save_pytree's
    jax.tree.map sorts them), else in the dicts' own order (to_bytes)."""
    if isinstance(node, dict):
        keys = list(node)
        if sort_keys and all(isinstance(k, str) for k in keys):
            keys.sort()
        f.write(_map_header(len(keys)))
        for k in keys:
            f.write(_scalar(k))
            _write(f, node[k], chunk, sort_keys)
    elif isinstance(node, (list, tuple)):
        f.write(_array_header(len(node)))
        for v in node:
            _write(f, v, False, sort_keys)
    elif _is_array(node):
        if chunk and _nbytes(node) > MAX_CHUNK_SIZE:
            _write_chunked(f, node)
        else:
            _write_array(f, node)
    elif isinstance(node, np.generic):
        _write_array(f, np.asarray(node), _EXT_NPSCALAR)
    else:
        f.write(_scalar(node))


def save_pytree(tree: Any, path: str, sort_keys: bool = True) -> None:
    """Write `tree` (dicts / lists of torch tensors, numpy arrays and
    Python scalars) to `path` in flax's msgpack layout, leaf by leaf."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        _write(f, tree, sort_keys=sort_keys)


# -- reader ------------------------------------------------------------------

class _Reader:
    def __init__(self, data: memoryview):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.obj() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        fmts = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
                0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
        if b in fmts:
            return self.unpack(fmts[b])
        lens = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if b in lens:
            return str(self.take(self.unpack(lens[b])), "utf-8")
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if b in lens:
            return self.take(self.unpack(lens[b]))
        if b in (0xdc, 0xdd):
            n = self.unpack(">H" if b == 0xdc else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"))
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            n = fixext[b]
        elif b in (0xc7, 0xc8, 0xc9):
            n = self.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
        else:
            raise ValueError(f"unknown msgpack type byte 0x{b:02x}")
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _array_from(payload: memoryview) -> torch.Tensor:
    r = _Reader(payload)
    if r.take(1)[0] != 0x93:
        raise ValueError("array payload is not (shape, dtype, bytes)")
    shape = tuple(r.obj())
    name = r.obj()
    name = str(name, "ascii") if isinstance(name, memoryview) else name
    raw = r.obj()
    if name == "bfloat16":
        a = np.frombuffer(raw, dtype=np.int16).copy()
        return torch.from_numpy(a).view(torch.bfloat16).reshape(shape)
    a = np.frombuffer(raw, dtype=np.dtype(name)).copy()
    return torch.from_numpy(a.reshape(shape))


def _ext(code: int, payload: memoryview):
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        return _array_from(payload)
    raise ValueError(f"msgpack ext type {code} is not an array")


def _unchunk(node):
    if isinstance(node, dict):
        if node.get(_CHUNKED) is True:
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            pieces = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            return torch.cat(pieces).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_unchunk(v) for v in node]
    if isinstance(node, memoryview):
        return bytes(node)
    return node


def load_pytree(path: str) -> Any:
    """The tree a flax msgpack file holds, arrays as CPU torch tensors
    (each copied once out of the mapped file)."""
    size = os.path.getsize(path)
    if not size:
        raise ValueError(f"{path}: empty msgpack file")
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    view = memoryview(mm)
    try:
        reader = _Reader(view)
        tree = _unchunk(reader.obj())
        if reader.pos != size:
            raise ValueError(f"{path}: {size - reader.pos} trailing bytes")
        return tree
    finally:
        reader = None
        view.release()
        mm.close()


# -- flax's state-dict form ----------------------------------------------------

def to_state_dict(tree: Any) -> Any:
    """flax.serialization.to_state_dict for dicts, lists, tuples and
    namedtuples: containers become string-keyed maps, leaves stay."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: to_state_dict(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def save_state(tree: Any, path: str) -> None:
    """flax to_bytes: `tree` (tuples and namedtuples allowed, e.g. an
    optimizer state) written in its state-dict form, keys in the order
    the tree holds them."""
    save_pytree(to_state_dict(tree), path, sort_keys=False)


def load_state(path: str) -> Any:
    """What save_state wrote, in its state-dict form (flax's
    msgpack_restore); the caller checks the keys."""
    return load_pytree(path)
