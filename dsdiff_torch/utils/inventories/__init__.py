"""Published-checkpoint key inventories (VERDICT r2 item 3).

Each JSON file is the literal ``{state_dict_key: shape}`` inventory of a
publicly released torch weight file the reference loads:

- ``sd_vae_ft_mse``      — stabilityai vae-ft-mse-840000 first stage, the
  CompVis layout ``ldm/models/autoencoder.py:111-120`` consumes (generated
  from the vendored torch Encoder/Decoder at the published ddconfig).
- ``torchvision_vgg16``  — torchvision VGG16 (LPIPS backbone,
  loss_function/perceptual_loss.py:21).
- ``torchvision_resnet50`` — torchvision/RadImageNet ResNet50 (MONAI
  perceptual backend).
- ``inception_v3_fid``   — pytorch-fid / torchmetrics-FID inception
  (pt_inception-2015-12-05: torchvision key names, 1008-class fc).
- ``lpips_vgg_lins``     — lpips v0.1 ``vgg.pth`` linear heads.

These lists are the *external* source of truth the weight mappers are
tested against — independent of the mapper code, so layout-assumption
drift fails the tests (scripts/gen_weight_inventories.py regenerates).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent

INVENTORIES = (
    "sd_vae_ft_mse",
    "torchvision_vgg16",
    "torchvision_resnet50",
    "inception_v3_fid",
    "lpips_vgg_lins",
)


def load_inventory(name: str) -> dict[str, tuple[int, ...]]:
    inv = json.loads((_DIR / f"{name}.json").read_text())
    return {k: tuple(v) for k, v in inv.items()}


class RecordingDict(dict):
    """State-dict stand-in that records which keys a mapper reads."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.read: set[str] = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if k in self:
            self.read.add(k)
        return super().get(k, default)

    def items(self):
        self.read.update(self.keys())
        return super().items()


def fake_state_dict(name: str, seed: int = 0) -> RecordingDict:
    """Random state_dict with exactly the published inventory layout."""
    inv = load_inventory(name)
    rng = np.random.default_rng(seed)
    out = RecordingDict()
    for k, shape in inv.items():
        if k.endswith("num_batches_tracked"):
            out[k] = np.asarray(0, np.int64)
        elif k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        else:
            out[k] = rng.normal(0, 0.05, shape).astype(np.float32)
    return out
