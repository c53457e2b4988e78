"""Smoke run of the PyTorch port (``dsdiff_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``dsdiff_torch/ops/csrc/``,
holds each against its plain PyTorch version at the main path's shapes and
times both (with one PyTorch library call beside them as a yardstick),
checks a full-width flagship DSUNet forward with the kernel against the same
forward with the plain attention, then serves three DDIM-20 requests through
``Trainer.sample_fn`` at 256² and checks that every attention call of them
went through the kernel. Weights are random, from a seed.

Exits non-zero, before printing any result, when there is no CUDA device or
when any phase fails. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from dsdiff_torch.models import attention as attention_module
from dsdiff_torch.models import build_model
from dsdiff_torch.ops import _build
from dsdiff_torch.ops import flash_attention as fa
from dsdiff_torch.train.trainer import Trainer
from dsdiff_torch.utils.device import disable_tf32
from dsdiff_torch.utils.flax_bridge import random_params

# configs/train_config.yaml merged with configs/dsdiff_gaussian.yaml, on
# every key the serving slice reads
FLAGSHIP_CONFIG = {
    "net_mode": "ds_diff_gaussian",
    "train_keys": ["F_Data1", "F_Data2", "S_Data1", "S_Data2"],
    "use_edge": False,
    "h5_2d_img_dir": "",
    "sampler_setting": {
        "sampler": "ddim", "ddim_use_original_steps": False, "sample_steps": 20,
    },
    "disentangle_distance": "eu",
    "contrast_lambda": 0.5,
    "output_ch": 1,
    "seed": 2024,
    "bf16": True,
    "parameterization": "v",
    "loss_type": "charbonnier",
    "noise_schedule": "linear",
    "linear_start": 1.0e-4,
    "linear_end": 2.0e-2,
    "diffusion_steps": 1000,
    "learn_sigma": True,
    "rescale_timesteps": False,
    "clip_denoised": True,
    "unet_config": {
        "params": {
            "model_channels": 96,
            "num_res_blocks": 2,
            "attention_resolutions": [8, 16, 32],
            "channel_mult": [1, 1, 2, 2, 3, 3],
            "num_head_channels": 48,
            "use_scale_shift_norm": True,
        }
    },
}

SEED = 0
IMAGE = 256
SERVE_BATCH = 4
SERVE_REQUESTS = 3
DDIM_STEPS = 20
# attention calls of one flagship forward at 256²: (N, heads, D, calls)
ATTENTION_CALLS = [(1024, 4, 48, 11), (256, 6, 48, 11), (64, 6, 48, 12)]
CALLS_PER_FORWARD = sum(c for *_, c in ATTENTION_CALLS)  # 34

# H100 SXM published dense peaks at 700 W
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain: f32 differs by summation order and exp2f (a few ulps);
# bf16 outputs are rounded from f32 in both, so they may differ by one bf16
# ulp (2^-8 at magnitude 1)
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# full-width f32 forward, TF32 off, kernel vs plain attention: relative to
# the output's largest magnitude
MODEL_RTOL = 1e-3


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, N, H, D, dtype):
    """(ms, 'bytes' | 'operations'): q, k, v, o moved once at the memory
    rate, or 4*B*H*N*N*D operations at the peak rate of ``dtype``."""
    elem = torch.finfo(dtype).bits // 8
    t_bytes = 4 * B * N * H * D * elem / PEAK_BYTES_PER_S
    t_ops = 4 * B * H * N * N * D / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}, {count} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"[device] {smi}")
    return name, count, smi


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel librar(ies) in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")


def phase_kernels(card: str):
    """Kernel vs plain at the flagship attention shapes; returns the rows."""
    disable_tf32()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for batch in (SERVE_BATCH, 16):
        for dtype in (torch.bfloat16, torch.float32):
            for N, H, D, calls in ATTENTION_CALLS:
                qkv = torch.randn(batch, N, 3, H, D, generator=gen,
                                  device="cuda", dtype=dtype)
                q, k, v = qkv.unbind(2)  # strided thirds, as the model's
                got = fa.flash_attention(q, k, v)
                torch.cuda.synchronize()
                want = fa.reference_attention(q, k, v)
                err = (got.float() - want.float()).abs().max().item()
                tol = KERNEL_TOL[dtype]
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                iters = 50 if N >= 1024 else 200
                ms = time_ms(lambda: fa.flash_attention(q, k, v), iters)
                plain_ms = time_ms(lambda: fa.reference_attention(q, k, v), iters)
                lib_ms = time_ms(
                    lambda: F.scaled_dot_product_attention(qt, kt, vt), iters
                )
                bound_ms, bound_by = attention_bound(batch, N, H, D, dtype)
                row = dict(shape=[batch, N, H, D], dtype=str(dtype).split(".")[1],
                           calls_per_forward=calls, max_abs_err=err, tol=tol,
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           share_of_bound=bound_ms / ms)
                rows.append(row)
                print(f"[kernel] flash_attention {row['shape']} {row['dtype']}: "
                      f"max_abs_err {err:.3e} (tol {tol:.0e}), kernel {ms:.5f} ms, "
                      f"plain {plain_ms:.5f} ms, sdpa {lib_ms:.5f} ms, "
                      f"bound {bound_ms:.5f} ms ({bound_by}), "
                      f"{100 * bound_ms / ms:.2f}% of bound [{card}]")
                check(err <= tol, f"flash_attention {row['shape']} "
                      f"{row['dtype']}: error {err} over {tol}")
    return rows


def phase_model_parity():
    """Full-width flagship DSUNet, f32, TF32 off: kernel vs plain attention."""
    disable_tf32()
    params = FLAGSHIP_CONFIG["unet_config"]["params"]
    model = build_model("dsunet", device="cuda", in_channels=4,
                        out_channels=2, dtype=torch.float32, **params).eval()
    random_params(model, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(2, IMAGE, IMAGE, 4, generator=gen, device="cuda")
    t = torch.tensor([17.0, 803.0], device="cuda")
    with torch.inference_mode():
        before = fa.LAUNCHES
        out_kernel, _ = model(x, t)
        launched = fa.LAUNCHES - before
        kernel_attention = attention_module.scaled_attention
        attention_module.scaled_attention = fa.reference_attention
        try:
            out_plain, _ = model(x, t)
        finally:
            attention_module.scaled_attention = kernel_attention
    torch.cuda.synchronize()
    err = (out_kernel - out_plain).abs().max().item()
    scale = out_plain.abs().max().item()
    tol = MODEL_RTOL * max(1.0, scale)
    print(f"[parity] DSUNet 256² batch 2 f32: max_abs_err {err:.3e} "
          f"(tol {tol:.3e}, max |out| {scale:.3f}), {launched} kernel launches")
    check(torch.isfinite(out_kernel).all().item(), "non-finite model output")
    check(launched == CALLS_PER_FORWARD,
          f"{launched} attention launches in one forward, not {CALLS_PER_FORWARD}")
    check(err <= tol, f"model parity error {err} over {tol}")
    del model


def phase_serve(smi: str):
    trainer = Trainer(dict(FLAGSHIP_CONFIG), device="cuda")
    random_params(trainer.model, SEED)
    print(f"[serve] DSUNet {trainer.n_params / 1e6:.2f} M params, bf16, "
          f"DDIM-{trainer.rsched.num_timesteps}, batch {SERVE_BATCH}, {IMAGE}²")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    conds = [torch.randn(SERVE_BATCH, IMAGE, IMAGE, trainer.n_cond,
                         generator=gen, device="cuda")
             for _ in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    fa.LAUNCHES = 0  # count only the main path from here
    per_request = CALLS_PER_FORWARD * DDIM_STEPS
    for i, cond in enumerate(conds):
        before = fa.LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = trainer.sample_fn(cond, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launched = fa.LAUNCHES - before
        print(f"[serve] request {i}: {wall:.4f} s, "
              f"{SERVE_BATCH / wall:.3f} slices/s, peak {peak:.3f} GiB, "
              f"{launched} attention launches [{smi}]")
        check(out.shape == (SERVE_BATCH, IMAGE, IMAGE, 1),
              f"output shape {tuple(out.shape)}")
        check(torch.isfinite(out).all().item(), "non-finite sample")
        check(out.abs().max().item() <= 1.0, "sample outside [-1, 1]")
        check(launched == per_request,
              f"{launched} attention launches in a request, not {per_request}")
    total = fa.LAUNCHES
    check(total == per_request * SERVE_REQUESTS,
          f"{total} attention launches, not {per_request * SERVE_REQUESTS}")
    return total


def kernels_line(rows, launches: int) -> dict:
    """One entry per kernel: its work in one serving forward (batch
    SERVE_BATCH, bf16), summed over the forward's attention calls."""
    serve = [r for r in rows
             if r["shape"][0] == SERVE_BATCH and r["dtype"] == "bfloat16"]

    def total(key):
        return sum(r[key] * r["calls_per_forward"] for r in serve)

    ops_ms = sum(r["bound_ms"] * r["calls_per_forward"] for r in serve
                 if r["bound_by"] == "operations")
    return {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "dsdiff_torch/ops/csrc/flash_attention.cu",
        "replaces": "dsdiff_tpu/ops/flash_attention.py:79",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in serve),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if ops_ms > total("bound_ms") / 2 else "bytes",
        "library_ms": total("library_ms"),
        "per": f"one DSUNet forward, batch {SERVE_BATCH}, bf16, "
               f"{CALLS_PER_FORWARD} calls",
    }]}


def main() -> None:
    name, count, smi = phase_device()
    phase_build()
    rows = phase_kernels(smi)
    phase_model_parity()
    launches = phase_serve(smi)
    print(json.dumps(kernels_line(rows, launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
