"""VAE training entry point.

Port of the JAX package's ``cli/train_vae.py`` (finetune_autoencoder):

    python -m dsdiff_torch.cli.train_vae --config_file configs/autoencoder_kl.yaml

trains the KL-VAE with its GAN and perceptual losses in
``<result_path>/<Task_name>_<Task_id>_vae`` (or under ``--workdir``); its
``checkpoint/`` directory is what a latent run's ``vae_checkpoint`` names.
It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_file", required=True)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--num_epochs", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    from ..train.config import load_run_config
    from ..train.vae_loop import VaeTrainer

    cfg = load_run_config(args.config_file)
    workdir = Path(args.workdir or cfg.get("result_path", "results")) / (
        f"{cfg.get('Task_name', 'vae')}_{cfg.get('Task_id', '0')}_vae"
    )
    trainer = VaeTrainer(cfg, workdir, device=args.device)
    step = trainer.fit(num_epochs=args.num_epochs, max_steps=args.max_steps)
    print(f"vae training finished at step {step}")
    return step


if __name__ == "__main__":
    main()
