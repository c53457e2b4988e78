"""Offline preprocessing: NIfTI dataset -> normalized H5 slice store.

    python -m dsdiff_torch.cli.preprocess --src SRC --dst DST \
        [--keys F_Data1 F_Data2 S_Data1 S_Data2] [--target 256] \
        [--norm minmax|zscore] [--test_frac 0.3] [--seed 42]

Port of the JAX package's ``cli/preprocess.py``; mirrors the preprocess/
chain (resample -> normalize -> split -> to_h5). Runs on the host.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="root of <case>/<key>.nii.gz")
    ap.add_argument("--dst", required=True)
    ap.add_argument("--keys", nargs="+",
                    default=["F_Data1", "F_Data2", "S_Data1", "S_Data2"])
    ap.add_argument("--target", type=int, default=256)
    ap.add_argument("--norm", default="minmax", choices=["minmax", "zscore"])
    ap.add_argument("--test_frac", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    from ..data.preprocess import preprocess_dataset

    train, test = preprocess_dataset(
        args.src, args.dst, keys=args.keys, target=args.target,
        norm=args.norm, test_frac=args.test_frac, seed=args.seed,
    )
    print(f"{len(train)} train / {len(test)} test cases -> {args.dst}")


if __name__ == "__main__":
    main()
