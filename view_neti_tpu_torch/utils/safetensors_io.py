"""A reader and a writer of the .safetensors format, with no dependency
beyond torch and the standard library.

The file is an 8-byte little-endian header length N, a JSON header of N
bytes ({name: {"dtype", "shape", "data_offsets": [begin, end]}}, plus an
optional "__metadata__" map of strings), then the tensors' raw
little-endian bytes, offsets counted from the end of the header. The
reader maps the file and wraps each tensor around the mapping with
torch.frombuffer, so that a multi-GB UNet file is not copied on the host
before it is loaded into a module.
"""
from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32}
NAMES = {v: k for k, v in DTYPES.items()}


def _header(data) -> tuple:
    if len(data) < 8:
        raise ValueError("not a safetensors file: shorter than 8 bytes")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"safetensors header of {n} bytes overruns the file")
    return json.loads(bytes(data[8:8 + n]).decode("utf-8")), 8 + n


def load_file(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a .safetensors file. The tensors view a
    private (copy-on-write) mapping of the file; the mapping stays alive as
    long as one of them does."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size == 0:
            raise ValueError(f"{path}: empty file")
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header, base = _header(mapped)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}; supported: {sorted(DTYPES)}")
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(x) for x in info["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} offsets {begin}-{end} "
                             f"do not hold {shape} {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (base + begin) % itemsize:
            # misaligned: copy the bytes out of the mapping
            out[name] = torch.frombuffer(
                bytearray(mapped[base + begin:base + end]),
                dtype=dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(mapped, dtype=dtype, count=count,
                                         offset=base + begin).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: Union[str, Path],
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write {name: tensor} as a .safetensors file, as the safetensors
    package lays it out: the widest dtypes first, then by name, so that
    every tensor starts on a multiple of its item size, and the header
    padded with spaces to a multiple of 8 bytes. Tensors are copied to the
    host one at a time."""
    for name, t in tensors.items():
        if t.dtype not in NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; "
                             f"supported: {sorted(DTYPES)}")
    order = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
