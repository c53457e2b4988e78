"""One run of one cell: set-up, the measured window, the traced
sub-window (``--trace 1``), then the comparison that decides ``correct``.

Serve mixes (``kind: serve``): one client sends requests back to back
through ``Trainer.sample_fn`` (closed loop; each request waits for its
result), each from the seeded pool. Train mixes (``kind: train``): back-to-
back ``Trainer.train_step`` calls on the seeded feed. Set-up ends after
the warm-up: a serve mix's first requests, or a train mix's first three
steps, which the check then follows. Every shape the window uses is run
in set-up, so nothing builds or compiles inside the window.
"""
from __future__ import annotations

import gc
import heapq
import importlib.util
import sys
import time

import numpy as np
import torch

from . import check, program
from .data import ServePool, TrainFeed
from .seeds import sub_seed
from .spec import Cell, metric_path
from .trace import Tracer, View

# top-level module names that must not be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dsdiff_tpu")


class ForbiddenModules(RuntimeError):
    pass


def log(message: str) -> None:
    print(f"[{time.perf_counter():.1f}] {message}", file=sys.stderr, flush=True)


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def read_metric(name: str, view: View):
    """The per-layer metric ``name`` from ``benchmark/metrics/<name>.py``'s
    ``read(view)``; None where it finds nothing to read."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(view)


class Span:
    """Calls ``first`` to ``last - 1`` of the window, traced by ``tracer``;
    ``counter()`` is read at both ends (the model calls made)."""

    def __init__(self, tracer: Tracer, first: int, last: int,
                 counter=lambda: 0):
        self.tracer, self.first, self.last = tracer, first, last
        self.counter = counter
        self.counts = [None, None]

    def at(self, done: int) -> None:
        if done == self.first:
            self.tracer.start()
            self.counts[0] = self.counter()
        if done == self.last:
            self.tracer.stop()
            self.counts[1] = self.counter()

    @property
    def open(self) -> bool:
        return self.counts[1] is None

    def view(self, cfg, traffic, kind: str, call_s) -> View:
        """What the span traced; ``call_s``: the host seconds an untraced
        call of the window took."""
        calls = dict(model_calls=self.counts[1] - self.counts[0])
        if kind == "train":
            calls = dict(steps=self.last - self.first)
        return View(self.tracer.events(), self.tracer.t1 - self.tracer.t0,
                    cfg, traffic, calls=self.last - self.first,
                    call_s=call_s, **calls)


def untraced_call_s(times: list, traced: list):
    """The mean host seconds of the window's calls that no span traced;
    None where every call was traced."""
    bounds = [(s.first, s.last) for s in traced]
    kept = [t for i, t in enumerate(times)
            if not any(a <= i < b for a, b in bounds)]
    return sum(kept) / len(kept) if kept else None


def spans(traffic: dict, device, counter=lambda: 0) -> list:
    """The traced spans of a ``--trace 1`` window: ``trace_calls`` calls
    after the first ``trace_after``, with the device alone traced (the
    per-layer metrics), then ``trace_host_calls`` calls with the host's
    ops too (the idle gaps named by what the host was doing; the host's
    tracing slows it, so these calls give no metric)."""
    a = int(traffic["trace_after"])
    b = a + int(traffic["trace_calls"])
    c = b + int(traffic["trace_host_calls"])
    return [Span(Tracer(device, host=False), a, b, counter),
            Span(Tracer(device, host=True), b, c, counter)]


def _window(seconds: float, call, traced: list):
    """Calls ``call(i)`` back to back until ``seconds`` have passed since
    the first, and until every span in ``traced`` has closed; each call
    returns True when its result was sound. Returns (calls done, failed,
    window seconds, each call's host seconds)."""
    start = time.perf_counter()
    end, done, failed, times = start, 0, 0, []
    while (time.perf_counter() - start < seconds
           or any(s.open for s in traced)):
        for s in traced:
            s.at(done)
        t = time.perf_counter()
        failed += 0 if call(done) else 1
        done += 1
        end = time.perf_counter()
        times.append(end - t)
    for s in traced:
        s.at(done)
    return done, failed, end - start, times


def run_serve(cell: Cell, seed: int, seconds: float, trace: bool, device,
              t0: float) -> dict:
    cfg, traffic = cell.config, cell.traffic
    wseed = sub_seed(seed, "weights")
    log(f"imports {time.perf_counter() - t0:.2f} s")
    trainer = program.build_trainer(cfg, wseed, device)
    pool = ServePool(cfg, traffic, seed, device)
    _sync(device)
    log(f"trainer and inputs {time.perf_counter() - t0:.2f} s")
    rec = program.Recorder(trainer.sample_model)
    if int(traffic["sample_steps"]) != int(
            cfg["trainer"]["sampler_setting"]["sample_steps"]):
        raise ValueError("the mix's sample_steps differ from the config's")
    for w in range(int(traffic["warmup_requests"])):
        cond, x_T = pool.request(w)
        trainer.sample_fn(cond, None, x_T)
    _sync(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.2f} s")

    rng = np.random.default_rng(sub_seed(seed, "checked"))
    K = int(traffic["checked_requests"])
    kept = []  # max-heap by key of (-key, index, inputs, output)

    def request(i):
        key = float(rng.random())
        recording = len(kept) < K or key < -kept[0][0]
        rec.active = [] if recording else None
        cond, x_T = pool.request(i)
        out = trainer.sample_fn(cond, None, x_T)
        sound = bool(torch.isfinite(out).all())
        if recording:
            heapq.heappush(kept, (-key, i, rec.active, out))
            if len(kept) > K:
                heapq.heappop(kept)
        rec.active = None
        return sound

    traced = spans(traffic, device, lambda: rec.calls) if trace else []
    done, failed, window_s, times = _window(seconds, request, traced)
    peak = _peak(device)
    log(f"window {window_s:.2f} s, {done} requests, peak {peak}")
    rec.close()
    del trainer
    _free(device)
    B = int(traffic["batch"])
    result = {"attempted": done, "failed": failed, "peak": peak,
              "setup_s": setup_s, "slices_per_s": done * B / window_s}
    if traced:
        call_s = untraced_call_s(times, traced)
        result["views"] = [s.view(cfg, traffic, "serve", call_s)
                           for s in traced]
    records = sorted((i, inputs, out) for _, i, inputs, out in kept)
    result["numbers"] = check.serve_numbers(cfg, traffic, wseed, device, pool,
                                            records)
    return result


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, device,
              t0: float) -> dict:
    cfg, traffic = cell.config, cell.traffic
    wseed = sub_seed(seed, "weights")
    log(f"imports {time.perf_counter() - t0:.2f} s")
    trainer = program.build_trainer(cfg, wseed, device)
    feed = TrainFeed(cfg, traffic, seed, device)
    _sync(device)
    log(f"trainer and inputs {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "feed") + 1)
    readings = check.TrainReadings(float(cfg["trainer"].get("beta1", 0.9)))
    fed = []
    for k in range(int(traffic["checked_steps"])):
        batch, t, noise = feed.next()
        fed.append((batch, t, noise))
        metrics = trainer.train_step(batch, gen, t=t, noise=noise)
        readings.after_step(k, metrics, lambda: program.state_snapshot(trainer),
                            wseed, device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.2f} s; losses {readings.losses}")

    def step(i):
        batch, t, noise = feed.next()
        metrics = trainer.train_step(batch, gen, t=t, noise=noise)
        return bool(torch.isfinite(metrics["loss"]))

    traced = spans(traffic, device) if trace else []
    done, failed, window_s, times = _window(seconds, step, traced)
    peak = _peak(device)
    log(f"window {window_s:.2f} s, {done} steps, peak {peak}")
    del trainer
    _free(device)
    B = int(traffic["batch"])
    result = {"attempted": done, "failed": failed, "peak": peak,
              "setup_s": setup_s, "slices_per_s": done * B / window_s}
    if traced:
        call_s = untraced_call_s(times, traced)
        result["views"] = [s.view(cfg, traffic, "train", call_s)
                           for s in traced]
    ref = check.reference_train_readings(cfg, wseed, device, fed)
    result["numbers"] = check.train_numbers(readings, ref)
    return result


def _end_to_end(metric: dict, res: dict) -> float:
    """A cell's end-to-end metric: ``setup_s``, or by its unit the
    window's rate (slices completed over the window, ``slices/s``)."""
    if metric["name"] == "setup_s":
        return res["setup_s"]
    if metric["unit"] == "slices/s":
        return res["slices_per_s"]
    raise ValueError(f"no reading for end-to-end metric {metric['name']}")


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    """One run; returns the result line's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``breakdown``, ``checks``) and
    ``peak`` (bytes) and ``window_s`` / ``busy_s`` of a traced window.
    Raises ``ForbiddenModules`` when a module of JAX or of the JAX package
    was loaded once the window closed."""
    kind = cell.traffic["kind"]
    runner = {"serve": run_serve, "train": run_train}[kind]
    res = runner(cell, seed, seconds, trace, device, t0)
    log("check done")
    found = forbidden_loaded()
    if found:
        raise ForbiddenModules(", ".join(found))
    out = {"attempted": res["attempted"], "failed": res["failed"],
           "peak": res["peak"]}
    metrics = {}
    if trace:
        view, host_view = res["views"]
        for m in cell.per_layer:
            value = read_metric(m["name"], view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["busy_s"], out["window_s"] = view.busy_s, view.window_s
        out["breakdown"] = {
            "device_ops": view.breakdown()["device_ops"],
            "idle_gaps": host_view.breakdown()["idle_gaps"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": _end_to_end(m, res),
                                  "unit": m["unit"]}
    out["metrics"] = metrics
    ok, checks = check.compare(res["numbers"], cell.limits)
    out["numbers"] = res["numbers"]
    out["checks"] = checks
    out["correct"] = bool(ok and res["failed"] == 0 and res["attempted"] > 0)
    return out
