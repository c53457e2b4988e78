"""Offline metric report: a predictions directory against the ground-truth
NIfTI root, one row per case and the mean, into a CSV report.

    python -m dsdiff_torch.cli.evaluate --pred_dir P --gt_root G \
        [--gt_name S_Data2.nii.gz] [--report P/metrics.csv]

Port of the JAX package's ``cli/evaluate.py``; runs on the host.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred_dir", required=True)
    ap.add_argument("--gt_root", required=True)
    ap.add_argument("--gt_name", default="S_Data2.nii.gz")
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)

    from ..eval.assemble import evaluate_predictions

    report = args.report or f"{args.pred_dir}/metrics.csv"
    rows = evaluate_predictions(args.pred_dir, args.gt_root, args.gt_name,
                                report_path=report)
    for r in rows:
        print(r)
    print(f"report: {report} ({len(rows)} cases)")


if __name__ == "__main__":
    main()
