"""Inference entry point: predict test slices -> NIfTI volumes -> metrics.

Port of the JAX package's ``cli/sample.py``
(inference/inference_2d_with_gaussian_main.py:26-110: checkpoint discovery,
predict, metric report):

    python -m dsdiff_torch.cli.sample --config_file configs/train_config.yaml \
        --workdir <training run dir>

restores the latest checkpoint under ``<workdir>/checkpoint``, samples the
test split from the EMA weights and writes ``*_pred.nii.gz`` volumes and,
given a ground-truth root, ``metrics.csv``. It runs on the card unless
``--device cpu``. ``--int8`` serves the denoiser's convolutions in int8
with dynamic activation scales, ``--int8 static`` with scales calibrated
on the val split (``Trainer.set_sampler``).
"""
from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_file", required=True)
    ap.add_argument("--model_config", default=None)
    ap.add_argument("--workdir", required=True,
                    help="training run dir containing checkpoint/")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--gt_root", default=None,
                    help="NIfTI ground-truth root for the metric report")
    ap.add_argument("--gt_name", default=None)
    ap.add_argument("--sampler", default=None,
                    help="override sampler (ddim|dpm++|ancestral|...)")
    ap.add_argument("--sample_steps", type=int, default=None)
    ap.add_argument("--int8", nargs="?", const="dynamic",
                    choices=("dynamic", "static"), default=None,
                    help="serve the convolutions in int8 (ops/quant.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to sample on (default cuda)")
    args = ap.parse_args(argv)

    from ..train.config import load_run_config
    from ..train.trainer import Trainer

    overrides = {}
    if args.sampler or args.sample_steps:
        samp = {}
        if args.sampler:
            samp["sampler"] = args.sampler
        if args.sample_steps:
            samp["sample_steps"] = args.sample_steps
        overrides["sampler_setting"] = samp
    cfg = load_run_config(args.config_file, args.model_config, overrides)
    trainer = Trainer(cfg, Path(args.workdir), device=args.device)
    trainer.state, trainer.sampler_state = trainer.ckpt.restore(
        trainer.state, trainer.sampler_state
    )
    if args.int8:
        trainer.set_sampler(int8="static" if args.int8 == "static" else True)
    out_dir, rows = trainer.predict(
        out_dir=args.out_dir,
        template_root=cfg.get("filepath_img"),
        gt_root=args.gt_root or cfg.get("filepath_img"),
        gt_name=args.gt_name,
    )
    print(f"wrote predictions to {out_dir} ({len(rows)} cases scored)")
    return out_dir, rows


if __name__ == "__main__":
    main()
