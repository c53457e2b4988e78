"""Training entry point.

Port of the JAX package's ``cli/train.py``, the reference's train mains
(training_project/train_main_*.py):

    python -m dsdiff_torch.cli.train --config_file configs/train_config.yaml

builds the trainer in ``<result_path>/<Task_name>_<Task_id>_<net_mode>_
fold<K>-<idx>`` (or under ``--workdir``), resumes from its latest
checkpoint (train_main_with_gaussian_diff.py:168-186) and runs ``fit``. It
runs on the card unless ``--device cpu``. Under a launcher it trains
data-parallel over every rank, one card each (``cuda:LOCAL_RANK``; gloo
ranks with ``--device cpu``) on a ('data', 'fsdp') mesh of (every rank, 1),
pure data parallelism as ``make_mesh()`` in the JAX package, the train
state sharded as the config's ``fsdp_min_size`` plans it:

    torchrun --nproc_per_node 4 -m dsdiff_torch.cli.train \
        --config_file configs/train_config.yaml
"""
from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_file", required=True)
    ap.add_argument("--model_config", default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--num_epochs", type=int, default=None)
    ap.add_argument("--no_resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    from ..parallel import dist
    from ..parallel.mesh import make_mesh
    from ..train.config import load_run_config
    from ..train.trainer import Trainer
    from ..utils.logging import journal

    dist.initialize(device=args.device)
    mesh = None
    device = args.device
    if dist.process_count() > 1:
        mesh = make_mesh()
        if device == "cuda":
            device = f"cuda:{dist.local_rank()}"
    cfg = load_run_config(args.config_file, args.model_config)
    task_name = cfg.get("Task_name", "task")
    task_id = cfg.get("Task_id", "0")
    net_mode = cfg.get("net_mode", "ds_diff_gaussian")
    fold = f"fold{cfg.get('fold_K', 5)}-{cfg.get('fold_idx', 1)}"
    run_name = f"{task_name}_{task_id}_{net_mode}_{fold}"
    workdir = Path(args.workdir or cfg.get("result_path", "results")) / run_name
    trainer = Trainer(cfg, workdir, device=device, mesh=mesh)
    if not args.no_resume and trainer.ckpt.latest_step() is not None:
        trainer.state, trainer.sampler_state = trainer.ckpt.restore(
            trainer.state, trainer.sampler_state
        )
        if dist.is_main():
            journal(workdir, f"resumed from step {trainer.ckpt.latest_step()}")
    step = trainer.fit(num_epochs=args.num_epochs, max_steps=args.max_steps)
    if dist.is_main():
        journal(workdir, f"training finished at step {step}")
    return step


if __name__ == "__main__":
    main()
