"""The yardstick's arithmetic on fixed inputs: the attention bound, the
family table, the trace's union, gaps and breakdown, and each per-layer
reader."""
import pytest
import torch

from benchmark.harness import families, peaks, runner, spec
from benchmark.harness.trace import View

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, start, dur, device, corr=0):
        self._v = (name, start, dur, device, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_attention_bound():
    # [8,1024,4,48] bf16: 4*8*4*1024*1024*48 / 989e12 = 6.514e-6 s of
    # operations against 8*8*1024*4*48*... bytes: operations bound it
    ops = 4 * 8 * 4 * 1024 * 1024 * 48 / 989e12
    byt = 2 * 8 * 2048 * 4 * 48 * 2 / 3.35e12
    assert peaks.attention_bound_s(8, 1024, 4, 48) == pytest.approx(max(ops, byt))
    assert ops > byt
    # [8,64,6,48]: bytes bound it
    ops = 4 * 8 * 6 * 64 * 64 * 48 / 989e12
    byt = 2 * 8 * 128 * 6 * 48 * 2 / 3.35e12
    assert peaks.attention_bound_s(8, 64, 6, 48) == pytest.approx(byt)
    assert byt > ops
    # f32: three TF32 passes
    assert peaks.attention_bound_s(1, 1024, 4, 192, bf16=False) == pytest.approx(
        3 * 4 * 4 * 1024 * 1024 * 192 / 495e12)
    cfg = {"trainer": {"bf16": True},
           "attention_calls": [[1024, 4, 48, 11], [64, 6, 48, 12]]}
    assert peaks.forward_attention_bound_s(cfg, 8) == pytest.approx(
        11 * peaks.attention_bound_s(8, 1024, 4, 48)
        + 12 * peaks.attention_bound_s(8, 64, 6, 48))


@pytest.mark.parametrize("name,fam", [
    ("void attn_fwd_wgmma<64>(...)", "flash_attention"),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>",
     "group_norm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", "convolution"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>", "convolution"),
    ("ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_stages_64x4_tn", "matmul"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>",
     "optimizer (foreach)"),
    ("void at::native::vectorized_elementwise_kernel<4, bfloat16_copy_kernel>",
     "copy / layout"),
    ("void at::native::vectorized_elementwise_kernel<4, silu_kernel>",
     "elementwise / reduce"),
    ("Memset (Device)", "copy / layout"),
    ("something_else", "other"),
])
def test_family_table(name, fam):
    assert families.family(name) == fam


def _view(**kw):
    events = [
        # host: one outer op enclosing a launch, a bare launch, a sync
        Ev("aten::group_norm", 0, 100, CPU),
        Ev("aten::native_group_norm", 10, 80, CPU),
        Ev("cudaLaunchKernel", 20, 5, CPU, corr=1),
        Ev("aten::conv2d", 200, 50, CPU),
        Ev("cudaLaunchKernel", 210, 5, CPU, corr=2),
        Ev("cudaLaunchKernel", 400, 5, CPU, corr=3),
        # device: gn 100-200, conv 300-400 and 350-450 (overlap), attn 600-700
        Ev("RowwiseMomentsCUDAKernel", 100, 100, CUDA, corr=1),
        Ev("sm90_xmma_fprop", 300, 100, CUDA, corr=2),
        Ev("cudnn::winograd", 350, 100, CUDA, corr=9),
        Ev("attn_fwd_wgmma", 600, 100, CUDA, corr=3),
    ]
    cfg = {"trainer": {"bf16": True}, "attention_calls": [[1024, 4, 48, 1]],
           "forward_flops_per_sample": 1e9}
    # the span traced one call; an untraced call took 1 us
    args = dict(window_s=1e-6, config=cfg, traffic={"batch": 2}, calls=1,
                call_s=1e-6)
    args.update(kw)
    return View(events, **args)


def test_view_union_gaps_and_families():
    v = _view(model_calls=2)
    assert v.launches == 4
    assert v.busy_s == pytest.approx(350e-9)  # 100 + 150 + 100
    assert v.family_s("convolution") == pytest.approx(200e-9)
    assert v.family_s("group_norm", "flash_attention") == pytest.approx(200e-9)
    # gaps: 200-300 ends at the conv launched in aten::conv2d; 450-600 at
    # the attention launched outside any op
    assert dict(v.gap_ns) == {"aten::conv2d": 100, "host between ops": 150}
    bd = v.breakdown()
    assert bd["device_ops"][0] == ["sm90_xmma_fprop", 100e-9] or \
        bd["device_ops"][0][1] == pytest.approx(100e-9)
    assert bd["idle_gaps"][0] == ["host between ops", 150e-9]


def test_serve_readers():
    v = _view(model_calls=2)
    read = runner.read_metric
    assert read("launches_per_call.serve", v) == 2.0
    assert read("conv_ms.serve", v) == pytest.approx(1e3 * 200e-9 / 2)
    assert read("norm_eltwise_ms.serve", v) == pytest.approx(1e3 * 100e-9 / 2)
    assert read("idle_share.serve", v) == pytest.approx(100 * (1 - 0.35))
    bound = 2 * peaks.attention_bound_s(2, 1024, 4, 48)
    assert read("attn_roofline.serve", v) == pytest.approx(100 * bound / 100e-9)
    assert read("mfu.serve", v) == pytest.approx(
        100 * 1e9 * 2 * 2 / 1e-6 / 989e12)


def test_train_readers():
    # four steps traced; an untraced step took 1 us
    v = _view(steps=4, calls=4)
    read = runner.read_metric
    assert read("norm_eltwise_ms.train", v) == pytest.approx(1e3 * 100e-9 / 4)
    assert read("optimizer_ms.train", v) is None  # no optimizer kernel traced
    assert read("mfu.train", v) == pytest.approx(
        100 * 3 * 1e9 * 2 / 1e-6 / 989e12)
    assert read("idle_share.train", v) == pytest.approx(
        100 * (1 - 350e-9 / 4 / 1e-6))


def test_untraced_call_time_leaves_out_the_traced_calls():
    spans = [runner.Span(None, 2, 4), runner.Span(None, 4, 5)]
    times = [1.0, 1.0, 9.0, 9.0, 9.0, 2.0]
    assert runner.untraced_call_s(times, spans) == pytest.approx(4.0 / 3)
    assert runner.untraced_call_s(times[:5], spans + [runner.Span(None, 0, 2)]) \
        is None


def test_readers_find_nothing_in_an_empty_trace():
    v = View([], 1.0, {"trainer": {}, "attention_calls": [],
                       "forward_flops_per_sample": 1}, {"batch": 1},
             model_calls=1, steps=1)
    for m in spec.benchmark()["per_layer"]:
        assert runner.read_metric(m["name"], v) is None, m["name"]
