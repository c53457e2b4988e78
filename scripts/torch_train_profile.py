"""Where the time of one flagship train step goes on a CUDA card.

    python scripts/torch_train_profile.py [--batch 32]

Builds the PyTorch port's flagship ``Trainer`` (bf16 compute over f32
master weights, remat, random weights from a seed, the config of
``chip_smoke.py``), takes two warm-up steps at batch 8 (or ``--batch``;
the config's own is 32), 256², on a batch held on the card, times three
steps without the profiler, then traces one step with ``torch.profiler``
and prints: the median step wall, device busy time (the sum of the CUDA
kernels' times; one stream), the idle share, kernel launches, peak memory,
and device time by kernel family (those of ``torch_serve_profile.py``) and
by kernel name. Exits non-zero when there is no CUDA device.
"""
import argparse
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import FLAGSHIP_CONFIG, IMAGE, SEED, TRAIN_BATCH  # noqa: E402
from dsdiff_torch.train.trainer import Trainer  # noqa: E402
from dsdiff_torch.utils.flax_bridge import random_params  # noqa: E402
from torch_serve_profile import device_us, family  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=TRAIN_BATCH)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    trainer = Trainer(dict(FLAGSHIP_CONFIG), device="cuda")
    random_params(trainer.model, SEED)
    trainer.reset_state()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B = args.batch
    batch = {
        "target": torch.rand(B, IMAGE, IMAGE, 1, generator=gen,
                             device="cuda") * 2 - 1,
        "image": torch.randn(B, IMAGE, IMAGE, trainer.n_cond, generator=gen,
                             device="cuda"),
    }
    for _ in range(2):  # warm-up: cuDNN heuristics, kernel build
        trainer.train_step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    peak = torch.cuda.max_memory_allocated() / 2**30

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, gen)
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

    print(f"card: {smi}")
    print(f"train step: batch {B}, {IMAGE}², bf16 compute, f32 master weights, "
          f"remat {bool(FLAGSHIP_CONFIG['remat'])}")
    print(f"wall {wall:.4f} s unprofiled, median of "
          + ", ".join(f"{w:.4f}" for w in walls)
          + f" ({B / wall:.3f} slices/s), {wall_prof:.4f} s profiled; "
          f"peak {peak:.3f} GiB")
    print(f"device busy {busy:.4f} s; idle share {1 - busy / wall:.4f} of the "
          f"unprofiled wall; {launches} kernel launches")
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
