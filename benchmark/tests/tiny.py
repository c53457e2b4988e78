"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
same files, the model cut by its kind's ``tiny`` (``benchmark.reference.
models``), batch 2 (and with ``bf16=False`` the program in f32); every
other setting as the cell has it."""
from __future__ import annotations

from benchmark.harness import spec
from benchmark.reference import models


def tiny_config(config: dict, bf16: bool = True) -> dict:
    cfg = models.denoiser(config["model"]).tiny(config)
    cfg["trainer"]["bf16"] = bf16
    return cfg


def tiny_traffic(traffic: dict, batch: int = 2) -> dict:
    return dict(traffic, batch=batch, pool_requests=3, pool_batches=4,
                trace_after=1, trace_calls=1)


def tiny_cell(name: str, batch: int = 2, bf16: bool = True):
    cell = spec.load_cell(name)
    cell.config = tiny_config(cell.config, bf16)
    cell.traffic = tiny_traffic(cell.traffic, batch)
    return cell
