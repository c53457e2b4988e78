"""Random weight files in the public layouts, for the port's tests (no JAX
here: the ``gpu`` tests import it on a machine without JAX): torchvision /
pytorch-fid ``inception_v3``, torchvision ``resnet50`` and ``vgg16``
state dicts of seeded random weights, and a hand-written .safetensors
writer."""
import json
import struct

import numpy as np
import torch

from dsdiff_torch.models import inception as PI

# torchvision VGG16 ``features``: (width, conv indices) per block
VGG16_LAYOUT = ((64, (0, 2)), (128, (5, 7)), (256, (10, 12, 14)),
                (512, (17, 19, 21)), (512, (24, 26, 28)))

_ST_NAMES = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
             torch.uint8: "U8", torch.bool: "BOOL"}


def write_safetensors(path, tensors: dict, metadata=None) -> None:
    """A .safetensors file written by hand: header length, JSON header,
    then each tensor's bytes."""
    header, blobs, offset = {}, [], 0
    if metadata is not None:
        header["__metadata__"] = metadata
    for name, t in tensors.items():
        t = t.contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t
               ).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


def random_inception_state_dict(seed: int = 0) -> dict:
    """A torchvision ``inception_v3`` state dict of random weights (He-scaled
    convs, BatchNorm statistics near 0 / 1) with its heads."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in PI.InceptionV3().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            val = np.array(100, np.int64)
        elif k.endswith("conv.weight"):
            val = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("running_var"):
            val = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("bn.weight"):
            val = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            val = 0.1 * rng.standard_normal(shape)
        sd[k] = torch.from_numpy(np.asarray(val).astype(
            np.int64 if val.dtype == np.int64 else np.float32))
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    return sd


def random_resnet50_state_dict(seed: int = 0) -> dict:
    """A torchvision ``resnet50`` state dict of random weights (He-scaled
    convs; BatchNorm weights near 1, means and biases small, variances in
    [0.5, 1.5]) with its ``fc`` head."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[key] = rng.standard_normal((cout, cin, k, k)) * np.sqrt(
            2.0 / (cin * k * k))

    def bn(prefix, c, gain=1.0):
        sd[f"{prefix}.weight"] = gain * (1.0 + 0.1 * rng.standard_normal(c))
        sd[f"{prefix}.bias"] = 0.1 * rng.standard_normal(c)
        sd[f"{prefix}.running_mean"] = 0.1 * rng.standard_normal(c)
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c)
        sd[f"{prefix}.num_batches_tracked"] = np.array(10, np.int64)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (n, mid) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for bi in range(n):
            t = f"layer{li + 1}.{bi}"
            conv(f"{t}.conv1.weight", mid, cin, 1)
            bn(f"{t}.bn1", mid)
            conv(f"{t}.conv2.weight", mid, mid, 3)
            bn(f"{t}.bn2", mid)
            conv(f"{t}.conv3.weight", 4 * mid, mid, 1)
            bn(f"{t}.bn3", 4 * mid, gain=0.3)  # keeps the residual sums tame
            if bi == 0:
                conv(f"{t}.downsample.0.weight", 4 * mid, cin, 1)
                bn(f"{t}.downsample.1", 4 * mid)
            cin = 4 * mid
    sd["fc.weight"] = np.zeros((1000, 2048))
    sd["fc.bias"] = np.zeros(1000)
    return {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if np.asarray(v).dtype == np.int64 else np.float32))
        for k, v in sd.items()}


def write_vgg16_file(path, seed: int = 10):
    """A torchvision VGG16 ``features`` state dict of random weights with
    the five lpips ``lin`` heads, saved with ``torch.save``."""
    rng = np.random.default_rng(seed)
    sd = {}
    cin = 3
    for width, idxs in VGG16_LAYOUT:
        for i in idxs:
            sd[f"features.{i}.weight"] = torch.from_numpy(
                (rng.standard_normal((width, cin, 3, 3))
                 / np.sqrt(9 * cin)).astype(np.float32))
            sd[f"features.{i}.bias"] = torch.from_numpy(
                (0.1 * rng.standard_normal(width)).astype(np.float32))
            cin = width
    for k, (w, _) in enumerate(VGG16_LAYOUT):
        sd[f"lin{k}.model.1.weight"] = torch.from_numpy(
            rng.uniform(0, 1, (1, w, 1, 1)).astype(np.float32))
    torch.save(sd, path)
