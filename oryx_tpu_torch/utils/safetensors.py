"""Read and write the safetensors format with numpy and torch only.

A file is an 8-byte little-endian header length n, n bytes of JSON (padded
with spaces to a multiple of 8) mapping each tensor's name to its dtype,
shape and [begin, end) byte offsets into the data that follows, with an
optional "__metadata__" of strings, then the raw little-endian data, no
holes. The writer orders the tensors by element size (largest first), so
every tensor starts aligned to its element size.

`load_file` memory-maps the file copy-on-write: each tensor is a CPU view of
the mapping, read from disk as it is touched and never copied in full, so a
7B checkpoint is not held twice while it is cast or quantized onto the card.
BF16 comes back as torch.bfloat16.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

_DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def read_header(path: str) -> tuple[dict, int]:
    """(header dict, byte offset of the data) of a safetensors file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def load_metadata(path: str) -> dict[str, str]:
    return read_header(path)[0].get("__metadata__", {}) or {}


def load_file(path: str) -> dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file, each a view of a
    copy-on-write memory map of it."""
    header, base = read_header(path)
    size = os.path.getsize(path)
    data = (torch.from_numpy(np.memmap(path, dtype=np.uint8, mode="c"))
            if size > base else torch.empty(0, dtype=torch.uint8))
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = _DTYPES[info["dtype"]]
        except KeyError:
            raise ValueError(
                f"{path}: {name} has dtype {info['dtype']!r} (known: "
                f"{sorted(_DTYPES)})") from None
        begin, end = info["data_offsets"]
        shape = list(info["shape"])
        itemsize = torch.empty(0, dtype=dtype).element_size()
        count = 1
        for d in shape:
            count *= d
        if end - begin != count * itemsize or base + end > size:
            raise ValueError(f"{path}: {name}'s offsets {begin, end} do not "
                             f"hold {shape} {info['dtype']}")
        raw = data[base + begin: base + end]
        if (base + begin) % itemsize:
            raw = raw.clone()  # a view would be misaligned for the dtype
        out[name] = raw.view(dtype).reshape(shape)
    return out


def as_tensor(t) -> torch.Tensor:
    """A tensor, or a numpy array as a tensor (raw or ml_dtypes 2-byte
    floats as bf16)."""
    if isinstance(t, torch.Tensor):
        return t.detach()
    a = np.asarray(t)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")  # torch takes no read-only arrays
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # raw bf16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_file(tensors: dict, path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write {name: tensor or numpy array} as one safetensors file
    (atomically: a temp sibling, then os.replace). Tensors on the card are
    copied to the host one at a time."""
    items = {k: as_tensor(v) for k, v in tensors.items()}
    for k, t in items.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{k}: dtype {t.dtype} has no safetensors name")
    order = sorted(items, key=lambda k: (-items[k].element_size(), k))
    header: dict = {}
    offset = 0
    for k in order:
        t = items[k]
        nbytes = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
            for k in order:
                t = items[k].cpu().contiguous()
                if t.numel():
                    f.write(t.reshape(-1).view(torch.uint8).numpy().data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_safetensors_dir(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory: the shards that
    `model.safetensors.index.json` names when it exists, else every
    `*.safetensors` file in name order. Raises FileNotFoundError when
    there is none."""
    index = os.path.join(path, "model.safetensors.index.json")
    out: dict[str, torch.Tensor] = {}
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        for shard in shards:
            out.update(load_file(os.path.join(path, shard)))
    elif os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith(".safetensors"):
                out.update(load_file(os.path.join(path, name)))
    if not out:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return out
