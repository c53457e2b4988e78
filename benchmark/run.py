"""The benchmark of the PyTorch / CUDA port (``dsdiff_torch``): one run of
one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Builds the cell's ``Trainer`` with weights
and inputs drawn from ``--seed`` on the card, warms up every shape the
window uses (that is the set-up, ``setup_s``), then drives the cell's
traffic for ``--seconds`` and compares what the timed path produced with
the plain f32 reference (``benchmark/reference/``). With ``--trace 1`` a few
calls of the window run under ``torch.profiler`` and the cell's per-layer
metrics are read from that trace; with ``--trace 0`` the run reports the
cell's end-to-end metrics. The last line of standard output is the result,
one JSON object; each compared number and its limit also close standard
error. Exits non-zero, with no result, when no CUDA card (or fewer than the
cell asks for) is present, or when a module of JAX or of the JAX package
was loaded by the time the window closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark.harness import runner, spec  # noqa: E402


def card_line() -> str:
    """The card's name, count and power limit, as ``nvidia-smi`` reads
    them ("unknown" where it cannot)."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = ["unknown"]
    return (f"card: {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}; nvidia-smi name, power.limit: "
            + " | ".join(smi))


def result_line(res: dict, chips: int, trace: bool, kind: str) -> dict:
    """The result's JSON object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (and with ``trace`` its ``busy_s`` and
    ``window_s``, and ``breakdown``), the numbers read but not compared,
    and last ``checks``: each compared number beside its limit."""
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": res["peak"]}
    if trace:
        device["busy_s"], device["window_s"] = res["busy_s"], res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if trace:
        line["breakdown"] = res["breakdown"]
    line["numbers"] = {k: v for k, v in res["numbers"].items()
                       if k not in res["checks"]}
    line["checks"] = res["checks"]
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    try:
        res = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T0)
    except runner.ForbiddenModules as err:
        print(f"modules of JAX or of the JAX package were loaded: {err}",
              file=sys.stderr)
        return 3
    # read after the run, so that nvidia-smi's time is not set-up's
    print(card_line(), flush=True)
    line = result_line(res, cell.chips, bool(args.trace),
                       torch.cuda.get_device_name(0))
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
