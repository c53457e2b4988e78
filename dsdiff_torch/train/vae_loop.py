"""VAE GAN training orchestrator.

Port of the JAX package's ``train/vae_loop.py`` (finetune_autoencoder and
AutoencoderKL's Lightning plumbing): a slice loader over the target
sequence only (``train_keys[-1]``, augmented), the AE step then the
discriminator step on every batch, the per-step cosine learning rate over
``num_epochs`` epochs, AdamW with betas (0.5, 0.9) for both networks, and
a checkpoint of the VAE's train state (not the discriminator's) every
``checkpoint_epoch`` epochs, when ``max_steps`` ends the run and after the
last epoch, ranked by ``neg_rec_loss`` (the last batch's reconstruction
loss, negated). The data store is the H5 slice store (``data_store: h5``,
the default) or the npy case store (``npy``), as the ``Trainer``'s.

Random numbers: each step's two posterior draws come from a generator on
the trainer's device seeded from (seed, number of earlier ``fit`` calls of
this trainer, step); weights initialise from ``seed``.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from ..data.pipeline import BatchLoader
from ..eval import metrics as M
from ..models.discriminator import PatchDiscriminator
from ..models.vae import AutoencoderKL
from ..utils.device import resolve_device
from ..utils.logging import KVLogger, journal
from .checkpoints import CheckpointManager
from .config import Config
from .state import TrainState, cosine_lr, make_optimizer
from .trainer import DATA_STORES, _step_seed
from .vae_trainer import VaeGanConfig, make_vae_steps

__all__ = ["VaeTrainer", "build_vae"]

_KEYS = ["F_Data1", "F_Data2", "S_Data1", "S_Data2"]


def build_vae(cfg: Config, device) -> AutoencoderKL:
    """The ``AutoencoderKL`` of ``first_stage.params`` (the SD f8 VAE's
    defaults), computing in bf16 unless ``bf16: false``, its f32 weights
    initialised from the config's ``seed``."""
    fs = dict(cfg.get_path("first_stage.params", {}) or {})
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(int(cfg.get("seed", 2024)))
        vae = AutoencoderKL(
            ch=int(fs.get("ch", 128)),
            ch_mult=tuple(fs.get("ch_mult", (1, 2, 4, 4))),
            num_res_blocks=int(fs.get("num_res_blocks", 2)),
            z_channels=int(fs.get("z_channels", 4)),
            embed_dim=int(fs.get("embed_dim", 4)),
            dtype=torch.bfloat16 if cfg.get("bf16", True) else torch.float32,
        )
    return vae.to(device)


class VaeTrainer:
    """Builds the VAE, the discriminator, their train states, the
    perceptual loss and the loader from a run config
    (``configs/autoencoder_kl.yaml``). ``device`` defaults to ``"cuda"``.
    ``workdir`` receives ``logs/`` and ``checkpoint/<step>/``."""

    def __init__(self, cfg: Mapping, workdir, device=None):
        cfg = Config.wrap(dict(cfg))
        self.cfg = cfg
        self.device = resolve_device(device or "cuda")
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.logger = KVLogger(self.workdir / "logs")
        seed = int(cfg.get("seed", 2024))
        dtype = torch.bfloat16 if cfg.get("bf16", True) else torch.float32

        self.vae = build_vae(cfg, self.device)
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(seed + 1)
            self.disc = PatchDiscriminator(
                base_channels=int(cfg.get("disc_channels", 64)),
                n_layers=int(cfg.get("disc_num_layers", 3)), dtype=dtype,
            ).to(self.device)

        # data: reconstruct the target sequence (the loader's keys[-1])
        store = cfg.get("data_store", "h5")
        if store not in DATA_STORES:
            raise ValueError(f"unknown data_store '{store}' "
                             f"(have {sorted(DATA_STORES)})")
        self.dataset_cls = DATA_STORES[store]
        self.keys = list(cfg.get("train_keys", _KEYS))
        self.split = f"images_tr_{int(cfg.get('image_size', 256))}"
        self.train_ds = self.dataset_cls(
            Path(cfg.get("h5_2d_img_dir")), split=self.split, keys=self.keys,
            augment=True, aug_prob=float(cfg.get("augmentation_prob", 0.4)),
        )
        self.batch_size = int(cfg.get("train_batch_size", 8))
        self.loader = BatchLoader(self.train_ds, self.batch_size, seed=seed)

        total = int(cfg.get("num_epochs", 100)) * max(len(self.loader), 1)
        lr = cosine_lr(float(cfg.get("lr", 4.5e-6)), total)
        self.vae_state = TrainState(
            self.vae, lambda p: make_optimizer(p, lr, betas=(0.5, 0.9)))
        self.disc_state = TrainState(
            self.disc, lambda p: make_optimizer(p, lr, betas=(0.5, 0.9)))
        self.logvar = torch.zeros((), device=self.device)

        gan_cfg = VaeGanConfig(
            kl_weight=float(cfg.get("kl_weight", 1e-6)),
            perceptual_weight=float(cfg.get("perceptual_weight", 1.0)),
            disc_start=int(cfg.get("disc_start", 50001)),
            disc_weight=float(cfg.get("disc_weight", 0.5)),
            disc_loss=cfg.get("disc_loss", "hinge"),
            decoder_only=bool(cfg.get("decoder_only", False)),
        )
        perceptual_fn = None
        if gan_cfg.perceptual_weight > 0:
            from ..eval.perceptual import PerceptualLoss

            perceptual_fn = PerceptualLoss(
                seed=seed, weights_path=cfg.get("perceptual_weights"),
                device=self.device,
            ).distance_fn()
        self.ae_step, self.d_step = make_vae_steps(
            self.vae, self.disc, gan_cfg, perceptual_fn)
        self.ckpt = CheckpointManager(self.workdir / "checkpoint",
                                      best_metric="neg_rec_loss")
        self._fit_calls = 0  # keys each fit call's step draws
        n = sum(p.numel() for p in self.vae.parameters())
        journal(self.workdir, f"VAE {n / 1e6:.2f}M params, "
                              f"{len(self.train_ds)} slices")

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @torch.inference_mode()
    def reconstruction_metrics(self, max_batches: int = 4) -> dict:
        """Reconstruction quality of the current weights: posterior mode ->
        decode, SSIM / PSNR / MAE averaged over the first ``max_batches``
        unaugmented, unshuffled batches of the training split."""
        eval_ds = self.dataset_cls(Path(self.cfg.get("h5_2d_img_dir")),
                                   split=self.split, keys=self.keys,
                                   augment=False)
        loader = BatchLoader(eval_ds, self.batch_size, seed=0, shuffle=False)
        rows = []
        for i, batch in enumerate(loader.epoch(0)):
            if i >= max_batches:
                break
            gt = self._to_device(batch["target"])
            pred = self.vae.decode(self.vae.encode(gt).mode())
            mse = float(torch.mean((gt - pred) ** 2))
            rows.append({
                "rec_ssim": float(torch.mean(
                    M.ssim(gt[..., 0], pred[..., 0], data_range=2.0))),
                "rec_psnr": 10.0 * float(np.log10(4.0 / max(mse, 1e-12))),
                "rec_mae": float(torch.mean(torch.abs(gt - pred))),
            })
        return {k: round(float(np.mean([r[k] for r in rows])), 4)
                for k in rows[0]}

    def fit(self, num_epochs: int | None = None, max_steps: int | None = None,
            log_every: int = 50) -> int:
        """Train ``num_epochs`` epochs (default the config's) or up to
        ``max_steps``; returns the step."""
        cfg = self.cfg
        num_epochs = num_epochs or int(cfg.get("num_epochs", 100))
        ckpt_every = max(int(cfg.get("checkpoint_epoch", 1)), 1)
        seed = int(cfg.get("seed", 2024))
        fit_call = self._fit_calls
        self._fit_calls += 1
        gen = torch.Generator(device=self.device)
        step = self.vae_state.step
        for epoch in range(num_epochs):
            t0 = time.time()
            for batch in self.loader.epoch(epoch):
                x = {"image": self._to_device(batch["target"])}
                gen.manual_seed(_step_seed(seed, fit_call, step))
                self.logvar, m = self.ae_step(self.vae_state, self.logvar, x,
                                              generator=gen)
                dm = self.d_step(self.disc_state, x, generator=gen)
                step += 1
                if step % log_every == 0:
                    for k, v in {**m, **dm}.items():
                        self.logger.logkv(k, float(v))
                    self.logger.logkv("step", step)
                    self.logger.dumpkvs()
                if max_steps and step >= max_steps:
                    break
            rec = float(m["rec_loss"])
            done = bool(max_steps and step >= max_steps)
            if (epoch + 1) % ckpt_every == 0 or done or epoch == num_epochs - 1:
                self.ckpt.save(step, self.vae_state,
                               metrics={"neg_rec_loss": -rec})
                journal(self.workdir, f"vae epoch {epoch} rec_loss {rec:.4f} "
                                      f"({time.time() - t0:.1f}s)")
            if done:
                break
        return step
