"""The DiT-XL/8 cell's own pieces: the stored linear-layer FLOPs, the GEMM
classifier of ``gemm_roofline.dit_train`` on the kernel names an H100's
trace printed, its reading, ``attn_roofline.dit_train``'s (forwards counted
from the trace's launches) and ``optimizer_ms.dit_train``'s on a fixed trace, and the device time inside named spans (``harness/op_spans.py``)
on a synthetic profiled step."""
from types import SimpleNamespace

import pytest

from benchmark.harness import op_spans, peaks, runner, spans, spec
from benchmark.harness.trace import View
from benchmark.reference import gemm_flops
from test_bench_arithmetic import CPU, CUDA, Ev

CELL = "dit-xl8-train-b32"
CONFIGS = [e for e in spec.benchmark()["configs"]
           if "gemm_flops_per_sample" in spec.load_json(spec.ROOT / e["file"])]


def _metric_module(name):
    ns = {}
    exec(spec.metric_path(name).read_text(), ns)
    return ns


@pytest.mark.parametrize("entry", CONFIGS, ids=lambda e: e["name"])
def test_stored_gemm_flops_are_the_reference_linear_count(entry):
    cfg = spec.load_json(spec.ROOT / entry["file"])
    assert cfg["gemm_flops_per_sample"] == gemm_flops.gemm_flops_per_sample(cfg)
    assert 0 < cfg["gemm_flops_per_sample"] < cfg["forward_flops_per_sample"]


# names as an H100's trace of the cell printed them (the patch embedding's
# cuDNN kernel, the attention VJP's f32 products), and cuBLAS's sm90 GEMM
@pytest.mark.parametrize("name, gemm", [
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN", True),
    ("nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN", True),
    ("nvjet_tst_64x32_64x16_4x1_v_bz_splitK_NNT", True),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_"
     "warpgroupsize2x1x1_execute_segment_k_off_kernel__5x_cublas", True),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", False),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
     "optimized_bf16_256x64_32x4_nhwc_align8>", False),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x32x8_stage3_"
     "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas", False),
    ("void magma_sgemmEx_kernel<float, float, float, false, true, 6, 4, 6, "
     "3, 4>", False),
    ("void (anonymous namespace)::attn_fwd_ws<2, 5>(CUtensorMap_st)", False),
    ("void (anonymous namespace)::softmax_warp_backward<float, float, float, "
     "10, false, false>", False),
])
def test_gemm_classifier_on_card_names(name, gemm):
    assert _metric_module("gemm_roofline.dit_train")["is_linear_gemm"](name) \
        is gemm


def _train_view(steps=2, attn_launches=4):
    """Two steps: a bf16 GEMM 300 ns, an f32 GEMM 200, a convolution 50,
    the attention kernel 100 over ``attn_launches`` launches (two forwards
    a step under remat), a LayerNorm 40, the optimizer 20."""
    events = [
        Ev("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN", 0, 300, CUDA),
        Ev("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", 300, 200, CUDA),
        Ev("sm90_xmma_fprop_implicit_gemm_bf16bf16", 500, 50, CUDA),
    ]
    each = 100 // max(attn_launches, 1)
    events += [Ev("void attn_fwd_ws<2, 5>", 550 + k * each, each, CUDA)
               for k in range(attn_launches)]
    events += [Ev("vectorized_layer_norm_kernel", 650, 40, CUDA),
               Ev("multi_tensor_apply_kernel", 690, 20, CUDA)]
    # one attention call a forward, so each launch is one forward
    cfg = {"trainer": {"bf16": True, "remat": True},
           "attention_calls": [[1024, 16, 72, 1]],
           "forward_flops_per_sample": 2e9, "gemm_flops_per_sample": 1e9}
    return View(events, 1e-6, cfg, {"batch": 32, "kind": "train"},
                steps=steps, calls=steps, call_s=1e-6)


def test_dit_rooflines_on_a_fixed_trace():
    v = _train_view()
    read = runner.read_metric
    bound = 3 * 1e9 * 32 / 989e12 * 2
    assert read("gemm_roofline.dit_train", v) == pytest.approx(
        100 * bound / 300e-9)
    attn = peaks.forward_attention_bound_s(v.config, 32)
    assert read("attn_roofline.dit_train", v) == pytest.approx(
        100 * attn * 2 * 2 / 100e-9)
    # a program that runs one forward a step whatever `remat` says is
    # held to one forward's bound, not the configuration's two
    assert read("attn_roofline.dit_train", _train_view(attn_launches=2)) == \
        pytest.approx(100 * attn * 2 / 100e-9)
    assert read("optimizer_ms.dit_train", v) == pytest.approx(10e-6)
    # a serve window has no steps, a window without the kernel no launch
    assert read("gemm_roofline.dit_train", _train_view(steps=0)) is None
    assert read("attn_roofline.dit_train", _train_view(steps=0)) is None
    assert read("attn_roofline.dit_train", _train_view(attn_launches=0)) \
        is None


def _profiled_steps(attention_span=True):
    """Two steps, each: a forward launch, a recompute launch inside
    ``model.remat`` and an attention-VJP launch inside
    ``attention.backward``, both within ``train.backward`` (the autograd
    thread's spans), then an optimizer launch."""
    R = spans.RANGE_PREFIX
    events = []
    for k, t0 in enumerate((0, 10_000)):
        c = 10 * k
        events += [
            Ev(R + "train.step", t0, 5000, CPU),
            Ev(R + "model.forward", t0 + 10, 1000, CPU),
            Ev("cudaLaunchKernel", t0 + 30, 5, CPU, corr=c + 1),
            Ev(R + "train.backward", t0 + 2000, 2000, CPU),
            Ev(R + "model.remat", t0 + 2100, 300, CPU),
            Ev("cudaLaunchKernel", t0 + 2200, 5, CPU, corr=c + 2),
            Ev("cudaLaunchKernel", t0 + 2500, 5, CPU, corr=c + 3),
            Ev("cudaLaunchKernel", t0 + 4500, 5, CPU, corr=c + 4),
            Ev("nvjet_fwd", t0 + 100, 40, CUDA, corr=c + 1),
            Ev("nvjet_recompute", t0 + 2300, 30, CUDA, corr=c + 2),
            Ev("magma_sgemmEx_kernel", t0 + 2600, 200, CUDA, corr=c + 3),
            Ev("multi_tensor_apply_kernel", t0 + 4600, 10, CUDA, corr=c + 4),
        ]
        if attention_span:
            events.append(Ev(R + "attention.backward", t0 + 2450, 400, CPU))
    return events


def _collect_returns(monkeypatch, events, host_ms=()):
    calls = []
    steps = [SimpleNamespace(name="train.step", ms=ms) for ms in host_ms]

    def fake(config, traffic, seed, device, tracer):
        calls.append(seed)
        return {"kind": "train", "events": events,
                "host": {"spans": steps, "counts": {}}}

    monkeypatch.setattr(spans, "collect", fake)
    monkeypatch.setattr(spans, "program_tracer", lambda: object())
    return calls


def test_named_ops_keep_each_kernel_and_its_spans():
    ops, ranges = op_spans.named_ops(_profiled_steps())
    assert ranges == {"train.step": 2, "model.forward": 2,
                      "train.backward": 2, "model.remat": 2,
                      "attention.backward": 2}
    first = [(n, c) for _, _, n, c in ops[:4]]
    assert first == [
        ("nvjet_fwd", ("model.forward", "train.step")),
        ("nvjet_recompute", ("model.remat", "train.backward", "train.step")),
        ("magma_sgemmEx_kernel",
         ("attention.backward", "train.backward", "train.step")),
        ("multi_tensor_apply_kernel", ("train.step",))]


@pytest.mark.parametrize("first", ["backward_ms.dit_train",
                                   "host_enqueue_ms.dit_train",
                                   "attn_backward_ms.dit_train"])
def test_span_readers_collect_once(monkeypatch, first):
    calls = _collect_returns(monkeypatch, _profiled_steps(), (3.0, 5.0, 4.0))
    v = _train_view()
    runner.read_metric(first, v)
    assert runner.read_metric("attn_backward_ms.dit_train", v) == \
        pytest.approx(200e-6)
    assert runner.read_metric("recompute_ms.dit_train", v) == \
        pytest.approx(30e-6)
    assert runner.read_metric("backward_ms.dit_train", v) == \
        pytest.approx(230e-6)
    assert runner.read_metric("host_enqueue_ms.dit_train", v) == 4.0
    assert len(calls) == 1
    # spans.read's readings are kept too, so its readers collect no more
    assert v.program_spans["backward_ms"] == pytest.approx(230e-6)


def test_span_readers_without_the_span_or_a_train_window(monkeypatch):
    calls = _collect_returns(monkeypatch, _profiled_steps(attention_span=False))
    v = _train_view()
    assert runner.read_metric("attn_backward_ms.dit_train", v) is None
    assert runner.read_metric("recompute_ms.dit_train", v) == \
        pytest.approx(30e-6)
    assert runner.read_metric("attn_backward_ms.dit_train",
                              _train_view(steps=0)) is None
    # no train.step span timed on the host: nothing to read
    assert runner.read_metric("host_enqueue_ms.dit_train", v) is None
    assert len(calls) == 1
    monkeypatch.setattr(spans, "program_tracer", lambda: None)
    for name in ("recompute_ms.dit_train", "backward_ms.dit_train",
                 "host_enqueue_ms.dit_train"):
        assert runner.read_metric(name, _train_view()) is None


def test_the_cell_reports_the_dit_metrics():
    cell = spec.load_cell(CELL)
    names = {m["name"] for m in cell.per_layer}
    assert names == {"mfu.dit_train", "idle_share.dit_train",
                     "gemm_roofline.dit_train", "attn_roofline.dit_train",
                     "attn_backward_ms.dit_train", "recompute_ms.dit_train",
                     "norm_eltwise_ms.dit_train", "optimizer_ms.dit_train",
                     "backward_ms.dit_train", "host_enqueue_ms.dit_train"}
    assert {m["name"] for m in cell.end_to_end} == {"train_slices_per_s",
                                                    "setup_s"}
    assert cell.config["trainer"]["remat"] and cell.traffic["kind"] == "train"
    assert cell.config["attention_calls"] == [[1024, 16, 72, 28]]
