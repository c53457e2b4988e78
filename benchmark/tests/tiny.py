"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
same files, the model at 32 channels over two levels, 32² images, batch
2 (and with ``bf16=False`` the program in f32); every other setting as
the cell has it."""
from __future__ import annotations

import copy

from benchmark.harness import spec


def tiny_cell(name: str, batch: int = 2, bf16: bool = True):
    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    params = cfg["trainer"]["unet_config"]["params"]
    params.update(model_channels=32, channel_mult=[1, 2],
                  attention_resolutions=[2])
    if "num_head_channels" in params:
        params["num_head_channels"] = 16
    else:
        params["num_heads"] = 2
    cfg["trainer"]["image_size"] = 32
    cfg["trainer"]["bf16"] = bf16
    cfg["attention_calls"] = [[256, 2, 16, 4]]
    cell.config = cfg
    cell.traffic = dict(cell.traffic, batch=batch, pool_requests=3,
                        pool_batches=4, trace_after=1, trace_calls=1)
    return cell
