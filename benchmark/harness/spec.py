"""The cells of ``BENCHMARK.json`` and the files each is made of.

A cell names a configuration (``configs`` entry -> its ``file``), a traffic
mix (``benchmark/traffic/<traffic>.json``) and the limits its comparison is
held to (``benchmark/limits/<cell>.json``); its metrics are the entries of
``end_to_end`` and ``per_layer`` that list it under ``workloads`` (or list
no cells). Each per-layer metric is read by ``benchmark/metrics/<name>.py``;
a configuration's reference denoiser is ``benchmark/reference/denoisers/
<model>.py`` (``benchmark.reference.models``). Everything is found by name:
a new cell, mix, configuration, model kind or metric is new files and new
entries.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "traffic" / f"{name}.json"


def limits_path(cell: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "limits" / f"{cell}.json"


def metric_path(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "metrics" / f"{name}.py"


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=load_json(traffic_path(w["traffic"], root)),
        limits=load_json(limits_path(name, root)),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )
