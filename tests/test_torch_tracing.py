"""The port's tracer (``dsdiff_torch.utils.profiling``) and the spans the
program opens, on the CPU (TINY models, f32, 16²):

- off, a span is one shared no-op context: nothing is recorded, no
  ``record_function`` opens, no memory is kept;
- on: nesting, parent and root ids, attributes, counters in the innermost
  span and in the process total, spans from a second thread under the
  open root, ``drain`` clearing, the bounded buffer, ``dsdiff/`` ranges in
  a ``torch.profiler`` trace;
- a DDIM-3 request gives one ``serve.request`` holding 3 ``model.forward``
  spans, each holding one ``model.encoders`` where the model encodes its
  streams (the flagship in both stream layouts, DisC-Diff), none on the
  cached and palette paths;
- a ``remat: true`` train step opens as many ``model.remat`` spans inside
  ``train.backward`` (the recompute) as inside its forward;
- tracing changes no output bit of a request or a train step;
- ``fit`` with ``trace_spans`` logs ``train_batch_wait_ms`` and
  ``train_to_device_ms``;
- on a card (marked ``gpu``): a flagship request and a train step raise as
  many sync warnings (``torch.cuda.set_sync_debug_mode``) traced as not.
  No JAX is imported, so on the card's machine it runs with
  ``python -m pytest --noconftest -m gpu tests/test_torch_tracing.py``.
"""
import json
import threading
import tracemalloc
import warnings
from collections import Counter

import pytest
import torch

from dsdiff_torch.data import synthetic
from dsdiff_torch.train.trainer import Trainer
from dsdiff_torch.utils import profiling as P
from torch_parity_utils import TINY, one_thread, tiny_cfg  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

STEPS = 3
UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=[2],
            channel_mult=[1, 2], num_heads=2, use_scale_shift_norm=True)
# run configs over the tiny flagship; True where the model encodes its
# streams in one ``model.encoders`` span a call
RUNS = {
    "flagship": ({}, True),
    "flagship_vmap": ({"unet_config": {"params": dict(TINY,
                                                      stream_mode="vmap")}},
                  True),
    "disc_diff": ({"net_mode": "disc_diff", "parameterization": "eps",
                   "learn_sigma": True, "unet_config": {"params": UNET}},
                  True),
    "split_cached": ({"net_mode": "ds_diff_split"}, False),
    "palette": ({"net_mode": "palette", "learn_sigma": False,
                 "disentangle_distance": None, "unet_config": {"params": UNET},
                 "palette": {"train_schedule": {"n_timestep": 2000,
                                                "linear_start": 1e-6,
                                                "linear_end": 0.01},
                             "test_schedule": {"n_timestep": 30,
                                               "linear_start": 1e-4,
                                               "linear_end": 0.09}}},
                False),
}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    P.disable()
    P.drain()
    yield
    P.disable()
    P.drain()


def _cfg(run="flagship", **kw):
    cfg = tiny_cfg(STEPS)
    cfg.update(image_size=16, **RUNS[run][0])
    cfg.update(kw)
    return cfg


def _request_inputs(seed=0, n_cond=3):
    g = torch.Generator().manual_seed(seed)
    cond = torch.rand((2, 16, 16, n_cond), generator=g) * 2 - 1
    x_T = torch.randn((2, 16, 16, 1), generator=g)
    return cond, x_T


def _batch(seed=1, n_cond=3):
    g = torch.Generator().manual_seed(seed)
    return {"target": torch.rand((2, 16, 16, 1), generator=g) * 2 - 1,
            "image": torch.rand((2, 16, 16, n_cond), generator=g) * 2 - 1}


def _children(spans, parent, name):
    return [r for r in spans if r.parent == parent.id and r.name == name]


def _ancestors(spans):
    """{span id: names of its ancestors}."""
    by_id = {r.id: r for r in spans}
    out = {}
    for r in spans:
        names, p = [], r.parent
        while p is not None:
            names.append(by_id[p].name)
            p = by_id[p].parent
        out[r.id] = names
    return out


def _range_names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(P.RANGE_PREFIX)]


# ------------------------------------------------------------ the tracer
def test_off_path_records_nothing_and_opens_no_range():
    assert not P.enabled()
    ctx = P.span("model.forward")
    assert ctx is P.span("serve.request", batch=2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.span("model.forward") as rec:
            assert rec is None
            torch.ones(4) + 1
        P.count("model.found_idle")
        P.count_idle("model.found_idle", torch.ones(1))
    assert _range_names(prof) == []
    assert P.drain() == {"spans": [], "counts": {}}
    assert "model.forward" not in P.scope_totals()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(10_000):
            with P.span("model.forward"):
                P.count("model.found_idle")
        kept = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert kept < 1024, kept


def test_nesting_ids_attributes_and_counters():
    P.enable()
    with P.span("serve.request", batch=8, steps=20) as root:
        P.count("c")
        with P.span("model.forward") as inner:
            P.count("c", 2)
            P.count("d")
        with P.span("model.forward") as second:
            pass
    P.count("c")  # outside every span: the total alone
    got = P.drain()
    assert [r.name for r in got["spans"]] == ["model.forward", "model.forward",
                                              "serve.request"]
    assert root.parent is None and root.root == root.id
    assert root.attrs == {"batch": 8, "steps": 20}
    for child in (inner, second):
        assert child.parent == root.id and child.root == root.id
    assert len({root.id, inner.id, second.id}) == 3
    assert root.counts == {"c": 1} and inner.counts == {"c": 2, "d": 1}
    assert second.counts == {}
    assert got["counts"] == {"c": 4, "d": 1}
    assert root.t0_ns <= inner.t0_ns <= inner.t1_ns <= second.t0_ns \
        <= second.t1_ns <= root.t1_ns
    assert inner.ms >= 0
    assert P.drain() == {"spans": [], "counts": {}}
    assert P.scope_totals()["serve.request"] > 0


def test_spans_from_a_second_thread_nest_under_the_open_root():
    P.enable()
    seen = {}

    def backward_thread():
        with P.span("model.remat") as remat:
            with P.span("inner") as inner:
                P.count("c")
        seen.update(remat=remat, inner=inner)

    with P.span("train.step") as step:
        with P.span("train.backward") as backward:
            t = threading.Thread(target=backward_thread)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    remat, inner = seen["remat"], seen["inner"]
    assert remat.parent == backward.id and remat.root == step.id
    assert inner.parent == remat.id and inner.root == step.id
    assert inner.counts == {"c": 1} and backward.counts == {}
    assert backward.t0_ns <= remat.t0_ns <= remat.t1_ns <= backward.t1_ns

    # with no root open, another thread's span is a root of its own
    alone = {}

    def root_thread():
        with P.span("fit.batch_wait") as rec:
            alone["rec"] = rec

    t = threading.Thread(target=root_thread)
    t.start()
    t.join(timeout=30)
    assert alone["rec"].parent is None
    assert alone["rec"].root == alone["rec"].id


def test_drain_clears_and_the_buffer_is_bounded():
    P.enable()
    for _ in range(P.SPAN_BUFFER + 5):
        with P.span("model.forward"):
            pass
    got = P.drain()["spans"]
    assert len(got) == P.SPAN_BUFFER
    assert got[0].id < got[-1].id
    assert P.drain()["spans"] == []


def test_spans_are_ranges_of_a_cpu_profiler_trace():
    P.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.span("model.forward"):
            with P.span("model.encoders"):
                torch.ones(8) @ torch.ones(8)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    outer, inner = events["dsdiff/model.forward"], events["dsdiff/model.encoders"]
    assert outer.start_ns() <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() \
        <= outer.start_ns() + outer.duration_ns()
    assert [r.name for r in P.drain()["spans"]] == ["model.encoders",
                                                    "model.forward"]


# ------------------------------------------------------ the program's spans
@pytest.mark.parametrize("run", sorted(RUNS))
def test_request_spans(run):
    trainer = Trainer(_cfg(run), device="cpu")
    cond, x_T = _request_inputs(n_cond=trainer.n_cond)
    P.enable()
    trainer.sample_fn(cond, None, x_T)
    P.disable()
    spans = P.drain()["spans"]
    roots = [r for r in spans if r.name == "serve.request"]
    assert len(roots) == 1
    root = roots[0]
    assert root.parent is None and root.attrs == {"batch": 2, "steps": STEPS}
    assert all(r.root == root.id for r in spans)
    calls = _children(spans, root, "model.forward")
    assert len(calls) == STEPS
    per_call = [len(_children(spans, c, "model.encoders")) for c in calls]
    assert per_call == [1 if RUNS[run][1] else 0] * STEPS
    assert Counter(r.name for r in spans) == Counter(
        {"serve.request": 1, "model.forward": STEPS,
         "model.encoders": STEPS if RUNS[run][1] else 0})


@pytest.mark.parametrize("stream_mode", ["sequential", "vmap"])
def test_remat_step_recomputes_every_block_inside_backward(stream_mode):
    cfg = _cfg(unet_config={"params": dict(TINY, stream_mode=stream_mode,
                                           remat=True)})
    trainer = Trainer(cfg, device="cpu")
    P.enable()
    trainer.train_step(_batch(), torch.Generator().manual_seed(0))
    P.disable()
    spans = P.drain()["spans"]
    up = _ancestors(spans)
    step = [r for r in spans if r.name == "train.step"]
    assert len(step) == 1 and all(r.root == step[0].id for r in spans)
    remat = [r for r in spans if r.name == "model.remat"]
    forward = [r for r in remat if "model.forward" in up[r.id]]
    backward = [r for r in remat if "train.backward" in up[r.id]]
    assert forward and len(forward) == len(backward)
    assert len(forward) + len(backward) == len(remat)
    assert all("model.encoders" in up[r.id] for r in forward[:2])


@pytest.mark.parametrize("run", ["flagship", "disc_diff"])
def test_tracing_changes_no_output_bit(run):
    """A request, and a train step from the same state, traced and not."""
    cfg = _cfg(run)
    outs, states = [], []
    for on in (False, True):
        trainer = Trainer(cfg, device="cpu")
        cond, x_T = _request_inputs(n_cond=trainer.n_cond)
        if on:
            P.enable()
        outs.append(trainer.sample_fn(cond, None, x_T))
        metrics = trainer.train_step(_batch(n_cond=trainer.n_cond),
                                     torch.Generator().manual_seed(0))
        P.disable()
        states.append((metrics, trainer.state.state_dict()))
    assert P.drain()["spans"]
    assert torch.equal(outs[0], outs[1])
    (m0, s0), (m1, s1) = states
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for part in ("params", "ema", "mu", "nu"):
        for name, t in s0[part].items():
            assert torch.equal(t, s1[part][name]), (part, name)


def test_fit_logs_batch_wait_and_to_device(tmp_path):
    store = tmp_path / "store"
    synthetic.make_structured_dataset(store, n_cases=5, n_slices=2, hw=16,
                                      seed=0, store="npy")
    cfg = _cfg(h5_2d_img_dir=str(store), data_store="npy",
               train_keys=["A", "B", "C", "GT"], train_batch_size=2,
               val_batch_size=2, fold_K=2, fold_idx=0, log_images=False,
               trace_spans=True)
    trainer = Trainer(cfg, tmp_path / "run", device="cpu")
    assert P.enabled()
    assert trainer.fit(num_epochs=1, log_every=1, val_on_done=False) == 2
    rows = [json.loads(line) for line in
            (tmp_path / "run" / "logs" / "progress.jsonl").read_text()
            .splitlines()]
    assert len(rows) == 2
    for row in rows:
        assert row["train_batch_wait_ms"] > 0
        assert row["train_to_device_ms"] > 0
    names = Counter(r.name for r in P.drain()["spans"])
    assert names["fit.batch_wait"] == 3  # two batches and the epoch's end
    assert names["fit.to_device"] == 2 and names["train.step"] == 2


# ------------------------------------------------------------ on the card
def _sync_warnings(fn) -> int:
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.gpu
def test_tracing_adds_no_sync_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _cfg(bf16=True, unet_config={"params": dict(TINY, remat=True)})
    trainer = Trainer(cfg, device="cuda")
    cond, x_T = (t.cuda() for t in _request_inputs())
    batch = {k: v.cuda() for k, v in _batch().items()}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def request():
        trainer.sample_fn(cond, None, x_T)

    def step():
        trainer.train_step(batch, gen)

    for fn in (request, step):
        fn()  # warm-up
        off = _sync_warnings(fn)
        P.enable()
        on = _sync_warnings(fn)
        P.disable()
        assert on == off, (fn.__name__, off, on)
    spans = Counter(r.name for r in P.drain()["spans"])
    assert spans["serve.request"] == 1 and spans["train.step"] == 1
    assert spans["model.remat"] > 0
