"""Safetensors reader/writer on numpy (no external deps).

Format: 8-byte little-endian header length, a JSON header mapping tensor name ->
{dtype, shape, data_offsets: [begin, end)}, then one raw byte buffer. Reading is mmap-
backed. Sharded HF checkpoints are read through ``model.safetensors.index.json``.
bf16 has no numpy dtype: it is read as raw uint16 (or upcast to f32) and written from a
uint16 view.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def bf16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    return (raw_u16.astype(np.uint32) << 16).view(np.float32)


class SafetensorsFile:
    """Lazy mmap-backed reader for one .safetensors file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        (hlen,) = struct.unpack("<Q", self._mm[:8])
        header = json.loads(self._mm[8: 8 + hlen].decode("utf-8"))
        self.metadata = header.pop("__metadata__", {})
        self.index = header
        self._data_start = 8 + hlen

    def keys(self):
        return self.index.keys()

    def tensor(self, name: str, upcast_bf16: bool = True) -> np.ndarray:
        info = self.index[name]
        begin, end = info["data_offsets"]
        buf = self._mm[self._data_start + begin: self._data_start + end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            raw = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
            return bf16_to_f32(raw) if upcast_bf16 else raw
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"unsupported dtype {info['dtype']}")
        return np.frombuffer(buf, dtype=_DTYPES[info["dtype"]]).reshape(shape)

    def close(self):
        self._mm.close()
        self._f.close()


def load_safetensors(path: str, upcast_bf16: bool = True) -> dict[str, np.ndarray]:
    """Load a single .safetensors file fully into a dict."""
    f = SafetensorsFile(path)
    try:
        return {k: f.tensor(k, upcast_bf16) for k in f.keys()}
    finally:
        f.close()


def load_checkpoint_dir(path: str, upcast_bf16: bool = True) -> dict[str, np.ndarray]:
    """Load an HF checkpoint dir: sharded (index.json) or single model.safetensors.

    With upcast_bf16=False, bf16 tensors come back as raw uint16 arrays."""
    idx = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            weight_map = json.load(f)["weight_map"]
        out: dict[str, np.ndarray] = {}
        for shard in sorted(set(weight_map.values())):
            out.update(load_safetensors(os.path.join(path, shard), upcast_bf16))
        return out
    single = os.path.join(path, "model.safetensors")
    return load_safetensors(single if os.path.exists(single) else path, upcast_bf16)


def save_safetensors(path: str, tensors: dict[str, np.ndarray], metadata: dict | None = None):
    """Write a .safetensors file; uint16 arrays are written as BF16."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        dt = "BF16" if arr.dtype == np.uint16 else _NAMES[arr.dtype]
        blob = arr.tobytes()
        header[name] = {"dtype": dt, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * ((-len(hjson)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)
