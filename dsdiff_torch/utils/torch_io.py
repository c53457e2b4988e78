"""Checkpoint-file readers: any torch-ecosystem weight file -> a flat
``{name: tensor}``.

Port of the readers of the JAX package's ``utils/torch_io.py``:

- ``load_safetensors``: the safetensors format is an 8-byte little-endian
  header length, a JSON header ``{name: {dtype, shape, data_offsets}}`` and
  one flat byte buffer; each tensor is read with ``torch.frombuffer`` in
  its own dtype (bf16 included), without the ``safetensors`` package;
- ``load_checkpoint``: a zip pickle (``torch.save`` since 1.6) through
  ``torch.load(weights_only=True)``, else safetensors, else the legacy
  tar/pickle format through ``torch.load``; unwraps the Lightning / LDM
  ``state_dict`` nesting and returns f32 for every leaf that is not f64,
  int64, int32 or bool, as the JAX reader does.

The torch -> Flax layout mapping and the SD-VAE key map of the JAX module
(``to_flax``, ``assign``, ``map_sd_vae``) have no counterpart here yet.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path

import torch

__all__ = ["load_safetensors", "load_checkpoint"]

_SAFETENSORS_DTYPES = {
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

# leaf dtypes kept as they are; every other one becomes f32
_KEPT = (torch.float64, torch.int64, torch.int32, torch.bool)


def load_safetensors(path) -> dict[str, torch.Tensor]:
    """Read a .safetensors file: ``{name: tensor}`` in the file's dtypes, on
    the CPU."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        buf = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[meta["dtype"]]
        lo, hi = meta["data_offsets"]
        if hi == lo:
            flat = torch.empty(0, dtype=dtype)
        else:
            flat = torch.frombuffer(bytearray(buf[lo:hi]), dtype=dtype)
        out[name] = flat.reshape(meta["shape"])
    return out


def _as_dict(obj):
    """A Lightning / LDM checkpoint's ``state_dict``, else ``obj``."""
    return obj["state_dict"] if isinstance(obj, dict) and "state_dict" in obj \
        else obj


def load_checkpoint(path) -> dict[str, torch.Tensor]:
    """Any torch-ecosystem checkpoint file -> flat ``{name: tensor}`` on the
    CPU: a zip pickle, safetensors or the legacy (pre-1.6) format, the
    ``state_dict`` nesting unwrapped, entries that are not tensors dropped,
    every leaf but f64, int64, int32 and bool made f32."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:4] == b"PK\x03\x04":
        obj = torch.load(path, map_location="cpu", weights_only=True)
    else:
        try:
            obj = load_safetensors(path)
        except Exception:
            obj = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in _as_dict(obj).items():
        if not isinstance(v, torch.Tensor):
            continue
        v = v.detach()
        if v.dtype not in _KEPT:
            v = v.float()
        out[str(k)] = v
    return out
