"""The FLOPs of one reference forward's linear layers at batch 1: the
matrix products (``aten.mm``, ``aten.addmm``) of ``FlopCounterMode``'s
count by operation, on the ``meta`` device. Convolutions and the attention
einsums (``aten.bmm``) are left out.

    python -m benchmark.reference.gemm_flops benchmark/configs/<name>.json
"""
from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import models

LINEAR_OPS = ("mm", "addmm")


def gemm_flops_per_sample(config: dict) -> int:
    """FLOPs of the linear layers of one forward of ``config``'s reference
    model at batch 1."""
    with torch.device("meta"):
        model = models.build(config)
        size = int(config["trainer"]["image_size"])
        x = torch.zeros(1, size, size, 1 + int(config["n_cond"]))
        t = torch.zeros(1)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x, t)
    by_op = counter.get_flop_counts()["Global"]
    return int(sum(n for op, n in by_op.items()
                   if op.__name__.split(".")[0] in LINEAR_OPS))


if __name__ == "__main__":
    for path in sys.argv[1:]:
        with open(path) as f:
            print(path, gemm_flops_per_sample(json.load(f)))
