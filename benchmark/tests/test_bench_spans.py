"""The metrics read from the program's spans (``harness/spans.py``): the
device attribution on a synthetic event list, the host readings, the
calls made on the CPU at a tiny size, and that none of it reaches the
readings the benchmark had before."""
import time

import pytest
import torch

from benchmark.harness import runner, spans, spec, trace
from benchmark.harness.trace import View
from test_bench_arithmetic import CPU, CUDA, Ev, _view
from tiny import tiny_cell

NEW = ("host_enqueue_ms", "found_idle", "encoders_ms", "outside_model_idle_ms",
       "backward_ms", "recompute_ms")


class Rec:
    def __init__(self, name, ms, counts=None):
        self.name, self.ms, self.counts = name, ms, counts or {}


def _serve_events():
    """One request: two model calls, the first with its encoders; a DDIM
    update between them; a range's device-side annotation event."""
    R = spans.RANGE_PREFIX
    return [
        Ev(R + "serve.request", 0, 1000, CPU),
        Ev(R + "model.forward", 10, 300, CPU),
        Ev(R + "model.encoders", 20, 100, CPU),
        Ev("cudaLaunchKernel", 30, 5, CPU, corr=1),    # in the encoders
        Ev("cudaLaunchKernel", 200, 5, CPU, corr=2),   # in the forward
        Ev("cudaLaunchKernel", 400, 5, CPU, corr=3),   # the DDIM update
        Ev(R + "model.forward", 500, 300, CPU),
        Ev("cudaLaunchKernel", 600, 5, CPU, corr=4),
        Ev("cudaLaunchKernel", 900, 5, CPU, corr=5),   # after the calls
        Ev(R + "model.forward", 100, 700, CUDA),       # gpu_user_annotation
        Ev("conv", 100, 50, CUDA, corr=1),
        Ev("gn", 250, 50, CUDA, corr=2),               # gap 100 after conv
        Ev("add", 420, 10, CUDA, corr=3),              # gap 120: outside
        Ev("conv", 650, 50, CUDA, corr=4),             # gap 220: inside
        Ev("copy", 950, 10, CUDA, corr=5),             # gap 250: outside
        Ev("memset", 990, 5, CUDA, corr=99),           # no launch matched
    ]


def test_device_ops_belong_to_the_spans_that_hold_their_launch():
    ops, ranges = spans.program_ops(_serve_events())
    assert [c for _, _, c in ops] == [
        ("model.encoders", "model.forward", "serve.request"),
        ("model.forward", "serve.request"), ("serve.request",),
        ("model.forward", "serve.request"), ("serve.request",), None]
    assert [n for *_, n in ranges] == ["serve.request", "model.forward",
                                       "model.encoders", "model.forward"]


def test_serve_readings():
    host = {"spans": [Rec("model.forward", 60.0, {"model.found_idle": 1}),
                      Rec("model.forward", 80.0), Rec("model.forward", 70.0),
                      Rec("model.forward", 90.0),
                      Rec("serve.request", 400.0)], "counts": {}}
    got = spans.read({"kind": "serve", "host": host,
                      "events": _serve_events()})
    assert got["host_enqueue_ms"] == pytest.approx(75.0)
    assert got["found_idle"] == pytest.approx(25.0)
    # 50 ns of encoder work over two model calls
    assert got["encoders_ms"] == pytest.approx(50e-6 / 2)
    # gaps 120 and 250 end at operations launched outside the calls
    assert got["outside_model_idle_ms"] == pytest.approx(370e-6)
    assert set(got) <= set(NEW)


def _train_events():
    R = spans.RANGE_PREFIX
    events = []
    for k, t0 in enumerate((0, 10_000)):
        events += [
            Ev(R + "train.step", t0, 5000, CPU),
            Ev(R + "model.forward", t0 + 10, 1000, CPU),
            Ev(R + "model.remat", t0 + 20, 500, CPU),
            Ev("cudaLaunchKernel", t0 + 30, 5, CPU, corr=10 * k + 1),
            Ev(R + "train.backward", t0 + 2000, 2000, CPU),
            # the recompute, on another thread, inside the backward
            Ev(R + "model.remat", t0 + 2100, 300, CPU),
            Ev("cudaLaunchKernel", t0 + 2200, 5, CPU, corr=10 * k + 2),
            Ev("cudaLaunchKernel", t0 + 2500, 5, CPU, corr=10 * k + 3),
            Ev("cudaLaunchKernel", t0 + 4500, 5, CPU, corr=10 * k + 4),
            Ev("forward", t0 + 100, 40, CUDA, corr=10 * k + 1),
            Ev("recompute", t0 + 2300, 30, CUDA, corr=10 * k + 2),
            Ev("grad", t0 + 2600, 200, CUDA, corr=10 * k + 3),
            Ev("adam", t0 + 4600, 10, CUDA, corr=10 * k + 4),
        ]
    return events


def test_train_readings():
    host = {"spans": [Rec("train.step", s) for s in (900.0, 880.0, 910.0)],
            "counts": {}}
    got = spans.read({"kind": "train", "host": host,
                      "events": _train_events()})
    assert got["host_enqueue_ms"] == pytest.approx(900.0)
    assert got["backward_ms"] == pytest.approx(230e-6)
    assert got["recompute_ms"] == pytest.approx(30e-6)
    assert "found_idle" not in got


def test_readings_leave_out_what_they_cannot_read():
    got = spans.read({"kind": "serve", "host": {"spans": [], "counts": {}},
                      "events": []})
    assert got == {}


def test_run_seed_from_the_command_line():
    assert spans.run_seed(["--workload", "x", "--seed", "3221225479",
                           "--trace", "1"]) == 3221225479
    assert spans.run_seed(["-q", "benchmark/tests"]) == 0


def test_no_program_tracer_reads_nothing_and_calls_nothing(monkeypatch):
    monkeypatch.setattr(spans, "program_tracer", lambda: None)
    monkeypatch.setattr(spans, "collect", lambda *a: pytest.fail("called"))
    v = _view(model_calls=2)
    assert all(runner.read_metric(m["name"], v) is None
               for m in spec.benchmark()["per_layer"]
               if m["name"].split(".")[0] in NEW)


@pytest.mark.parametrize("cell_name", ["flagship-serve-b8",
                                       "flagship-train-b32"])
def test_collect_on_the_cpu(cell_name):
    """The calls at a tiny size: the host readings, the ranges of every
    span in the profiled calls, and the tracer left off."""
    torch.manual_seed(0)
    cell = tiny_cell(cell_name)
    tracer = spans.program_tracer()
    got = spans.collect(cell.config, cell.traffic, 3 * 2**30 + 7, "cpu",
                        tracer)
    kind = cell.traffic["kind"]
    assert not tracer.enabled() and tracer.drain()["spans"] == []
    assert len(got["untraced_s"]) == len(got["traced_s"]) \
        == spans.TRACED_CALLS[kind]
    _, ranges = spans.program_ops(got["events"])
    names = {n for *_, n in ranges}
    read = spans.read(got)
    assert read["host_enqueue_ms"] > 0
    if kind == "serve":
        assert {"serve.request", "model.forward", "model.encoders"} <= names
        assert read["found_idle"] == 0.0  # no card to find idle
    else:
        assert {"train.step", "model.forward", "train.backward",
                "model.remat"} <= names


def test_the_window_holds_no_program_range(monkeypatch):
    """The window's traced calls run with the program's tracer off, so
    the readings the benchmark had before see none of its ranges."""
    seen = []
    events = trace.Tracer.events

    def kept(self):
        out = events(self)
        seen.append([e.name() for e in out])
        return out

    monkeypatch.setattr(trace.Tracer, "events", kept)
    cell = tiny_cell("flagship-serve-b8")
    res = runner.run(cell, 3 * 2**30 + 7, 0.5, True, "cpu", time.perf_counter())
    assert len(seen) == 2 and all(seen)
    assert not any(n.startswith(spans.RANGE_PREFIX) for names in seen
                   for n in names)
    assert res["metrics"] == {}  # the CPU traces no device operation


def test_the_new_readers_leave_the_other_readings_as_they_were(monkeypatch):
    tiny, collect = tiny_cell("flagship-serve-b8"), spans.collect
    monkeypatch.setattr(spans, "collect", lambda cfg, traffic, seed, dev, tr:
                        collect(tiny.config, tiny.traffic, seed, "cpu", tr))
    v = _view(model_calls=2)
    names = [m["name"] for m in spec.benchmark()["per_layer"]]
    old = [n for n in names if n.split(".")[0] not in NEW]
    before = ({n: runner.read_metric(n, v) for n in old}, v.breakdown(),
              v.busy_s, v.window_s)
    assert runner.read_metric("host_enqueue_ms.serve", v) > 0
    assert runner.read_metric("found_idle.serve", v) == 0.0
    after = ({n: runner.read_metric(n, v) for n in old}, v.breakdown(),
             v.busy_s, v.window_s)
    assert before == after


def test_view_of_an_empty_window_has_no_program_readings():
    v = View([], 1.0, {"trainer": {}}, {"batch": 1, "kind": "serve"})
    assert spans.readings(v) is None
