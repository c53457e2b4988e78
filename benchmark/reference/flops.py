"""Model FLOPs of one reference forward, counted by
``torch.utils.flop_counter.FlopCounterMode`` at batch 1 on the ``meta``
device (shapes only, no arithmetic). Plain attention is two einsums, so its
4·N·M·D·heads FLOPs are counted with the convolutions and linear layers.

    python -m benchmark.reference.flops benchmark/configs/<name>.json
"""
from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import models


def forward_flops_per_sample(config: dict) -> int:
    """FLOPs of one forward of ``config``'s reference model at batch 1."""
    with torch.device("meta"):
        model = models.build(config)
        size = int(config["trainer"]["image_size"])
        x = torch.zeros(1, size, size, 1 + int(config["n_cond"]))
        t = torch.zeros(1)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x, t)
    return int(counter.get_total_flops())


if __name__ == "__main__":
    for path in sys.argv[1:]:
        with open(path) as f:
            print(path, forward_flops_per_sample(json.load(f)))
