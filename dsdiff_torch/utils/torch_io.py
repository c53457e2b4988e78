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

It also ports the torch -> Flax layout mapping and the SD-VAE key map:

- ``to_flax`` / ``map_sd_vae``: copies of the JAX functions on host arrays,
  giving the same Flax paths (``params/encoder/conv_in/kernel``) and
  layouts, key for key;
- ``assign``: mapped Flax-layout arrays onto a torch module. The module's
  state dict is seen as its Flax tree (``utils.flax_bridge.flax_leaves``),
  each mismatched tensor is shape-fit there by ``train.surgery.fit_tensor``
  (make_it_fit parity), and the tree maps back to a state dict. The fit
  must happen in the Flax layout: ``fit_tensor`` divides by a use count
  only when the trailing dims agree, so a 3-channel ``conv_in`` fit onto
  one channel keeps input channel 0 unscaled as HWIO [3,3,3,128] ->
  [3,3,1,128], where the OIHW [128,3,3,3] -> [128,1,3,3] would halve it;
- ``load_sd_vae``: an SD / HF VAE file fit onto an ``AutoencoderKL``.
"""
from __future__ import annotations

import json
import re
import struct
from pathlib import Path

import numpy as np
import torch

from ..train.surgery import fit_tensor
from .flax_bridge import flax_leaves, flax_to_state_dict

__all__ = ["load_safetensors", "load_checkpoint", "to_flax", "assign",
           "map_sd_vae", "load_sd_vae"]

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
        except Exception as e:
            try:
                obj = torch.load(path, map_location="cpu", weights_only=True)
            except Exception:
                raise ValueError(
                    f"unrecognized checkpoint format: {path}") from e
    out = {}
    for k, v in _as_dict(obj).items():
        if not isinstance(v, torch.Tensor):
            continue
        v = v.detach()
        if v.dtype not in _KEPT:
            v = v.float()
        out[str(k)] = v
    return out


# ------------------------------------------------------------- layout mapping
def to_flax(name: str, value):
    """One torch parameter in the Flax layout: (leaf name, array). Conv
    weights OIHW -> HWIO ``kernel``, linear weights transposed ``kernel``,
    1-D weights ``scale``, biases ``bias``."""
    value = np.asarray(value)
    if name.endswith(".weight"):
        if value.ndim == 4:  # conv
            return "kernel", value.transpose(2, 3, 1, 0)
        if value.ndim == 2:  # linear
            return "kernel", value.T
        if value.ndim == 1:  # norm
            return "scale", value
    if name.endswith(".bias"):
        return "bias", value
    return name.rsplit(".", 1)[-1], value


def assign(model: torch.nn.Module, mapped: dict, make_fit: bool = True):
    """Assign ``{flax_path: array}`` onto ``model``'s parameters.

    Shape mismatches go through ``surgery.fit_tensor`` in the Flax layout
    when ``make_fit`` (else raise); target leaves with no source keep the
    model's values and are listed in ``missing``. Returns (state dict on
    the CPU in f32, missing Flax paths, unused source paths), the lists as
    the JAX function gives them.
    """
    target = flax_leaves(model)
    out, missing, used = {}, [], set()
    # in the order JAX flattens a param tree: by key, level by level
    for k in sorted(target, key=lambda path: path.split("/")):
        tv = target[k]
        if k in mapped:
            sv = np.asarray(mapped[k])
            used.add(k)
            if sv.shape != tv.shape:
                if not make_fit:
                    raise ValueError(
                        f"shape mismatch at {k}: {sv.shape} vs {tv.shape}")
                sv = fit_tensor(sv, tv.shape)
            out[k] = sv.astype(tv.dtype)
        else:
            missing.append(k)
            out[k] = tv
    unused = sorted(set(mapped) - used)
    tree: dict = {}
    for k, v in out.items():
        *mods, leaf = k.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return flax_to_state_dict(tree, model), missing, unused


# ----------------------------------------------------------------- SD VAE map
def _vae_block(side: str, level: int, idx: int) -> str:
    return f"{side}_{level}_{idx}"


def map_sd_vae(state_dict: dict) -> dict[str, np.ndarray]:
    """CompVis SD VAE state dict -> Flax paths of ``models.vae.AutoencoderKL``
    (whose torch modules carry the same names), arrays in the Flax layout.

    Accepts bare VAE checkpoints (``encoder.*`` / ``decoder.*`` /
    ``quant_conv.*``), full SD checkpoints (``first_stage_model.*``
    prefix, stripped as autoencoder.py:111-120 strips it) and Lightning
    ``model.`` prefixes. 1x1 attention convs become Dense kernels.
    """
    sd = {}
    for k, v in state_dict.items():
        for pref in ("first_stage_model.", "model."):
            if k.startswith(pref):
                k = k[len(pref):]
        sd[k] = np.asarray(v)

    mapped: dict[str, np.ndarray] = {}

    def put(flax_path: str, torch_key: str, norm: bool = False):
        if torch_key not in sd:
            return
        leaf, val = to_flax(torch_key, sd[torch_key])
        # GroupNorm32 wraps an inner GroupNorm named 'norm'
        sub = "/norm" if norm else ""
        mapped[f"params/{flax_path}{sub}/{leaf}"] = val

    def put_res(flax_prefix: str, torch_prefix: str):
        for part in ("norm1", "conv1", "norm2", "conv2", "nin_shortcut"):
            for suf in ("weight", "bias"):
                put(f"{flax_prefix}/{part}", f"{torch_prefix}.{part}.{suf}",
                    norm=part.startswith("norm"))

    def put_attn(flax_prefix: str, torch_prefix: str):
        for suf in ("weight", "bias"):
            put(f"{flax_prefix}/norm", f"{torch_prefix}.norm.{suf}",
                norm=True)
        for part in ("q", "k", "v", "proj_out"):
            w = sd.get(f"{torch_prefix}.{part}.weight")
            if w is not None:
                # 1x1 conv [O, I, 1, 1] -> Dense kernel [I, O]
                mapped[f"params/{flax_prefix}/{part}/kernel"] = (
                    w[:, :, 0, 0].T if w.ndim == 4 else w.T
                )
            b = sd.get(f"{torch_prefix}.{part}.bias")
            if b is not None:
                mapped[f"params/{flax_prefix}/{part}/bias"] = b

    # levels present in the checkpoint
    levels = sorted({
        int(m.group(1))
        for k in sd
        for m in [re.match(r"encoder\.down\.(\d+)\.", k)]
        if m
    })
    blocks = sorted({
        int(m.group(2))
        for k in sd
        for m in [re.match(r"encoder\.down\.(\d+)\.block\.(\d+)\.", k)]
        if m
    })
    for suf in ("weight", "bias"):
        put("encoder/conv_in", f"encoder.conv_in.{suf}")
        put("encoder/conv_out", f"encoder.conv_out.{suf}")
        put("encoder/norm_out", f"encoder.norm_out.{suf}", norm=True)
        put("decoder/conv_in", f"decoder.conv_in.{suf}")
        put("decoder/conv_out", f"decoder.conv_out.{suf}")
        put("decoder/norm_out", f"decoder.norm_out.{suf}", norm=True)
        put("quant_conv", f"quant_conv.{suf}")
        put("post_quant_conv", f"post_quant_conv.{suf}")
    for lv in levels:
        for b in blocks:
            put_res(f"encoder/{_vae_block('down', lv, b)}",
                    f"encoder.down.{lv}.block.{b}")
        for suf in ("weight", "bias"):
            put(f"encoder/down_{lv}_ds",
                f"encoder.down.{lv}.downsample.conv.{suf}")
    put_res("encoder/mid_res1", "encoder.mid.block_1")
    put_res("encoder/mid_res2", "encoder.mid.block_2")
    put_attn("encoder/mid_attn", "encoder.mid.attn_1")
    put_res("decoder/mid_res1", "decoder.mid.block_1")
    put_res("decoder/mid_res2", "decoder.mid.block_2")
    put_attn("decoder/mid_attn", "decoder.mid.attn_1")
    up_levels = sorted({
        int(m.group(1))
        for k in sd
        for m in [re.match(r"decoder\.up\.(\d+)\.", k)]
        if m
    })
    up_blocks = sorted({
        int(m.group(2))
        for k in sd
        for m in [re.match(r"decoder\.up\.(\d+)\.block\.(\d+)\.", k)]
        if m
    })
    for lv in up_levels:
        for b in up_blocks:
            put_res(f"decoder/{_vae_block('up', lv, b)}",
                    f"decoder.up.{lv}.block.{b}")
        for suf in ("weight", "bias"):
            put(f"decoder/up_{lv}_us",
                f"decoder.up.{lv}.upsample.conv.{suf}")
    return mapped


def load_sd_vae(path, vae: torch.nn.Module):
    """Read an SD / HF VAE checkpoint file and fit it onto ``vae`` (an
    ``AutoencoderKL``; the vae-ft-mse init, autoencoder.py:111-120 +
    trainer_latent_diffusion.py:136-151). Returns (state dict, missing,
    unused) as ``assign`` does, mismatched shapes fit; the caller loads the
    state dict."""
    return assign(vae, map_sd_vae(load_checkpoint(path)))
