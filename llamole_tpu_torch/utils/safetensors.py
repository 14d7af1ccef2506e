"""The safetensors file format, read and written by this module alone
(counterpart of the `safetensors` package calls in
llamole_tpu/models/gllm/convert.py; the port needs no such package).

A file is: a little-endian u64 N, then N bytes of JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...} with an
optional "__metadata__" map of strings, padded with spaces to a multiple
of 8, then the tensors' raw C-order little-endian bytes, offsets counted
from the end of the header.

`iter_safetensors` reads a checkpoint directory (model.safetensors, or
the shards model.safetensors.index.json names) through mmap, one tensor
at a time: each tensor is a CPU view of the mapped file, so an 8B
checkpoint is never held in host memory twice. `save_file` writes as the
package does (tensors ordered by dtype, widest first, then by name; the
header compact, in offset order) and streams one tensor at a time to the
disk, so tensors may live on the card.
"""

import json
import mmap
import os
import struct
from typing import Dict, Iterator, Mapping, Tuple

import torch

# safetensors dtype name -> torch dtype; BF16 is read as int16 and
# viewed as bfloat16
_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
           "F32": torch.float32, "F64": torch.float64, "I64": torch.int64,
           "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
           "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}
# the package lays tensors out by this rank of their dtype, highest first
_RANK = {name: i for i, name in enumerate(
    ("BOOL", "U8", "I8", "I16", "F16", "BF16", "I32", "F32", "F64", "I64"))}
INDEX_FILE = "model.safetensors.index.json"
SINGLE_FILE = "model.safetensors"


def _read_header(path: str) -> Tuple[Dict, int]:
    """(header without __metadata__, byte offset of the data section)."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def iter_file(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) of one file in header order; each tensor is a
    copy-on-write view of the mapped file (writing to it never reaches
    the disk)."""
    header, base = _read_header(path)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
              if size else None)
    for name, info in sorted(header.items(),
                             key=lambda kv: kv[1]["data_offsets"][0]):
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise NotImplementedError(
                f"{path}: tensor {name} has dtype {info['dtype']}, which "
                "the port does not read")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        numel = 1
        for d in shape:
            numel *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != numel * itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name} has offsets "
                             f"{begin}..{end} for shape {shape}")
        if numel == 0:
            yield name, torch.empty(shape, dtype=dtype)
            continue
        read_as = torch.int16 if dtype == torch.bfloat16 else dtype
        t = torch.frombuffer(mm, dtype=read_as, count=numel,
                             offset=base + begin)
        yield name, t.view(dtype).reshape(shape)


def checkpoint_files(path: str) -> list:
    """The safetensors files of a checkpoint directory: the shards its
    index names, else model.safetensors; FileNotFoundError if neither."""
    index = os.path.join(path, INDEX_FILE)
    if os.path.exists(index):
        with open(index) as f:
            names = sorted(set(json.load(f)["weight_map"].values()))
        return [os.path.join(path, n) for n in names]
    single = os.path.join(path, SINGLE_FILE)
    if os.path.exists(single):
        return [single]
    raise FileNotFoundError(f"no safetensors under {path}")


def iter_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every (name, CPU tensor) of a checkpoint directory, one at a time."""
    for fname in checkpoint_files(path):
        yield from iter_file(fname)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def save_file(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write `tensors` (on any device) to `path`, one tensor at a time,
    with the metadata {"format": "pt"} that transformers asks for."""
    order = sorted(tensors, key=lambda k: (-_RANK[_NAMES[tensors[k].dtype]],
                                           k))
    header: Dict = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name in order:
        t = tensors[name]
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + _nbytes(t)]}
        offset += _nbytes(t)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(memoryview(t.reshape(-1).numpy()).cast("B"))
