"""Readings that set a cell's limits: the compared numbers of sound runs of
the program over many seeds, of the control, and of planted faults, in one
process (one set-up for all seeds). The benchmark's own runs never run it.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--half-batch-seeds 4,5,6]

Each seed: the weights and inputs of that seed written into one live
``Trainer``, then what a run checks: a serve cell's sampled requests
(``checked_requests`` of them, each followed by the reference step by step),
or a train cell's first three steps against the reference's. Beside the
numbers a run compares, each reading prints numbers that only calibration
reads: a serve request's gap to the reference's own free-running chain from
the same x_T (``free_gap_max``, ``free_gap_rms``); a train cell's relative
loss gap of the first step (``loss_gap_step1``) and the worst of the three
(``loss_gap``), and the first gradient's leaf-norm gaps (``grad_gap`` the
worst leaf, ``grad_gap_median``, ``grad_gap_p90``). Controls: a serve
cell's program with its int8 path on (``set_sampler(int8=True)``), a train
cell's reference in fp8 in the program's place. Faults (train): the program
with half of each batch left out of the loss, the mean taken over the rest.
Prints one JSON line per reading and a summary line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark.harness import check, program, spec, weights  # noqa: E402
from benchmark.harness.data import ServePool, TrainFeed  # noqa: E402
from benchmark.harness.seeds import sub_seed  # noqa: E402


@contextlib.contextmanager
def half_batch_fault():
    """The program's objective over the first half of each batch only."""
    from dsdiff_torch.train import step as step_mod

    real = step_mod.train_loss

    def half(task, sched, model, x0, cond, t, noise, weights_, mesh=None):
        h = x0.shape[0] // 2
        return real(task, sched, model, x0[:h], cond[:h], t[:h], noise[:h],
                    weights_[:h], mesh)

    step_mod.train_loss = half
    try:
        yield
    finally:
        step_mod.train_loss = real


@torch.no_grad()
def free_running_gaps(cfg, traffic, wseed, device, pool, records) -> dict:
    """The widest and the largest RMS gap between each request's output and
    the reference's own chain from the same x_T."""
    steps = int(traffic["sample_steps"])
    gap_max = gap_rms = 0.0
    with check.reference_mode():
        step = check.reference_stepper(cfg, steps, wseed, device)
        for idx, _, output in records:
            cond, x = pool.request(idx)
            for i in range(steps):
                x = step(x, cond, i)
            d = output - x
            gap_max = max(gap_max, float(d.abs().max()))
            gap_rms = max(gap_rms, float(d.pow(2).mean().sqrt()))
    return {"free_gap_max": gap_max, "free_gap_rms": gap_rms}


def read_only_train(prog, ref) -> dict:
    """The train numbers calibration reads beside the compared ones."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]

    def norms(grad):
        return {n: float(torch.linalg.vector_norm(g.float()))
                for n, g in grad.items()}

    grads = sorted(check.leaf_gaps(norms(prog.grad_t), norms(ref.grad_t)))
    return {"loss_gap_step1": losses[0], "loss_gap": max(losses),
            "grad_gap_median": statistics.median(grads),
            "grad_gap_p90": grads[min(len(grads) - 1, int(0.9 * len(grads)))],
            "grad_gap": grads[-1]}


def serve_reading(trainer, cell, seed, device, int8=False):
    cfg, traffic = cell.config, cell.traffic
    wseed = sub_seed(seed, "weights")
    weights.fill(trainer.model, wseed)
    trainer.reset_state()
    trainer.set_sampler(int8=bool(int8))
    pool = ServePool(cfg, traffic, seed, device)
    rec = program.Recorder(trainer.sample_model)
    records = []
    try:
        for i in range(int(traffic["checked_requests"])):
            rec.active = []
            cond, x_T = pool.request(i)
            out = trainer.sample_fn(cond, None, x_T)
            records.append((i, rec.active, out))
            rec.active = None
    finally:
        rec.close()
    nums = check.serve_numbers(cfg, traffic, wseed, device, pool, records)
    nums.update(free_running_gaps(cfg, traffic, wseed, device, pool, records))
    return nums


def train_reading(trainer, cell, seed, device, control=False,
                  half_batch=False):
    cfg, traffic = cell.config, cell.traffic
    wseed = sub_seed(seed, "weights")
    feed = TrainFeed(cfg, traffic, seed, device)
    fed = [feed.next() for _ in range(int(traffic["checked_steps"]))]
    ref = check.reference_train_readings(cfg, wseed, device, fed)
    if control:
        prog = check.reference_train_readings(cfg, wseed, device, fed, "fp8")
    else:
        weights.fill(trainer.model, wseed)
        trainer.reset_state()
        prog = check.TrainReadings(float(cfg["trainer"].get("beta1", 0.9)))
        gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "feed") + 1)
        with half_batch_fault() if half_batch else contextlib.nullcontext():
            for k, (batch, t, noise) in enumerate(fed):
                m = trainer.train_step(batch, gen, t=t, noise=noise)
                prog.after_step(k, m, lambda: program.state_snapshot(trainer),
                                wseed, device)
    nums = check.train_numbers(prog, ref)
    nums.update(read_only_train(prog, ref))
    nums["losses"] = prog.losses
    nums["ref_losses"] = ref.losses
    return nums


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--half-batch-seeds", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    cell = spec.load_cell(args.workload)
    device = "cuda"
    t0 = time.perf_counter()
    trainer = program.build_trainer(cell.config, 0, device)
    serve = cell.traffic["kind"] == "serve"
    rows = []

    def emit(kind, seed, nums):
        row = {"kind": kind, "seed": seed, "numbers": nums,
               "t": round(time.perf_counter() - t0, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in seeds(args.seeds):
        emit("program", seed, serve_reading(trainer, cell, seed, device)
             if serve else train_reading(trainer, cell, seed, device))
    for seed in seeds(args.control_seeds):
        emit("control", seed,
             serve_reading(trainer, cell, seed, device, int8=True) if serve
             else train_reading(trainer, cell, seed, device, control=True))
    for seed in seeds(args.half_batch_seeds):
        emit("half_batch", seed, train_reading(trainer, cell, seed, device,
                                               half_batch=True))
    summary = {}
    for row in rows:
        for name, v in row["numbers"].items():
            if isinstance(v, float):
                lo, hi = summary.setdefault(row["kind"], {}).get(name, (v, v))
                summary[row["kind"]][name] = (min(lo, v), max(hi, v))
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
