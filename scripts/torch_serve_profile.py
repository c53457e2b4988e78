"""Where the time of one flagship DDIM-20 request goes on a CUDA card.

    python scripts/torch_serve_profile.py [--net-mode ds_diff_split]

Builds the PyTorch port's flagship ``Trainer`` (bf16, random weights from a
seed, the config of ``chip_smoke.py``; with ``--net-mode ds_diff_split`` the
split model served through its cached-condition sampler), serves one
warm-up request, times
one request without the profiler, then traces one request with
``torch.profiler`` and prints: wall time, device busy time (the sum of the
CUDA kernels' times; one stream, so they do not overlap), the idle share,
kernel launches, and device time by kernel family and by kernel name.
Exits non-zero when there is no CUDA device.
"""
import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import (  # noqa: E402
    FLAGSHIP_CONFIG,
    IMAGE,
    SEED,
    SERVE_BATCH,
    SPLIT_CONFIG,
)
from dsdiff_torch.train.trainer import Trainer  # noqa: E402
from dsdiff_torch.utils.flax_bridge import random_params  # noqa: E402

# kernel-name fragments -> family, first match wins
FAMILIES = [
    ("flash_attention", ("attn_fwd",)),
    ("group_norm", ("group_norm", "GroupNorm", "RowwiseMoments",
                    "ComputeFusedParams", "groupnorm")),
    ("convolution", ("conv", "xmma", "cutlass", "implicit", "sm90_",
                     "nchwToNhwc", "nhwcToNchw", "cudnn")),
    ("matmul", ("gemm", "Gemm", "sgemm", "cublas")),
    ("optimizer (foreach)", ("multi_tensor", "foreach", "Foreach")),
    ("copy / layout", ("copy", "Copy", "cat", "Cat", "memcpy", "Memcpy",
                       "memset", "Memset", "upsample", "Upsample")),
    ("elementwise / reduce", ("elementwise", "reduce", "Reduce", "silu",
                              "vectorized", "unrolled", "Softmax",
                              "softmax", "index", "Index")),
]


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


CONFIGS = {"ds_diff_gaussian": FLAGSHIP_CONFIG, "ds_diff_split": SPLIT_CONFIG}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--net-mode", choices=sorted(CONFIGS),
                        default="ds_diff_gaussian")
    net_mode = parser.parse_args().net_mode
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    trainer = Trainer(dict(CONFIGS[net_mode]), device="cuda")
    random_params(trainer.model, SEED)
    trainer.reset_state()  # sample_fn serves the EMA, which starts here
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cond = torch.randn(SERVE_BATCH, IMAGE, IMAGE, trainer.n_cond,
                       generator=gen, device="cuda")

    trainer.sample_fn(cond, gen)  # warm-up: cuDNN heuristics, kernel build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.sample_fn(cond, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.sample_fn(cond, gen)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    busy = sum(device_us(e) for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    by_family = defaultdict(float)
    for e in kernels:
        by_family[family(e.key)] += device_us(e) / 1e6

    steps = trainer.rsched.num_timesteps
    print(f"card: {smi}")
    print(f"request: {net_mode} ({trainer.model_name}), DDIM-{steps}, batch "
          f"{SERVE_BATCH}, {IMAGE}², bf16")
    print(f"wall {wall:.4f} s unprofiled ({SERVE_BATCH / wall:.3f} slices/s), "
          f"{wall_prof:.4f} s profiled")
    print(f"device busy {busy:.4f} s; idle share {1 - busy / wall:.4f} of the "
          f"unprofiled wall; {launches} kernel launches "
          f"({launches / steps:.0f} per step)")
    print("device time by family:")
    for fam, sec in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:24s} {sec:.4f} s  {100 * sec / busy:6.2f} %")
    print("top kernels by device time:")
    for e in sorted(kernels, key=device_us, reverse=True)[:25]:
        sec = device_us(e) / 1e6
        print(f"  {sec:.4f} s {100 * sec / busy:6.2f} % {e.count:6d}x "
              f"[{family(e.key)}] {e.key[:110]}")


if __name__ == "__main__":
    main()
