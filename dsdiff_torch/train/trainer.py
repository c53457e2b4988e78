"""The training orchestrator: data -> model -> train steps -> checkpoints,
logs, validation and volume prediction.

Port of the JAX package's ``train/trainer.py`` ``Trainer`` on one card:
the K-fold patient split and loaders (``_setup_data``), the net_mode /
schedule / variance defaults, ``TaskConfig``, the model build (bf16 compute
over f32 master parameters, ``remat``) for every denoiser the run config
names: ``ds_diff_gaussian``, the cached-condition ``ds_diff_split``,
``ddpm`` (UNet), ``disc_diff`` (DiscUNet, one stream per input channel,
with its com/dist loss) and ``dit`` (DiT, sized by ``ViT_config``); the
gamma-conditioned ``palette`` pipeline (its own train and test schedules,
the denoiser given ``gamma * 1000``, DDIM or ancestral sampling) and the
``latent`` pipeline (a UNet over the latents of a frozen KL-VAE restored
from ``vae_checkpoint``, a directory ``train.vae_loop.VaeTrainer`` wrote:
``fit`` encodes each batch, ``validate``, ``predict`` and
``progressive_denoise`` encode the conditions and decode the sample); the
cosine learning rate over
``len(train_loader)`` steps an epoch, AdamW, the EMA, the schedule sampler,
the train step, ``fit`` (shannon curriculum, logging, validation and
checkpoints with best-val-SSIM retention), every sampler over the EMA
weights (``set_sampler`` switches on a live trainer), ``validate`` with its
image dumps, ``progressive_denoise`` and ``predict`` (test slices -> NIfTI
volumes -> metric report). The data store is the H5 slice store
(``data_store: h5``, the default) or the npy case store (``npy``).
``unet_config.params`` reaches the model as the JAX trainer passes it, the
transformer path's keys too (``fusion: crossattn``,
``use_spatial_transformer``, ``transformer_depth``,
``use_fft_attention``); ``split_input_params`` makes every sampler but the
cached one split-input (``train.step.make_sample_fn``), also after
``set_sampler``.

Under a mesh (``Trainer(cfg, workdir, mesh=parallel.mesh.make_mesh(...))``,
every rank of the process group building its own trainer) each rank trains
on its rows of every global batch (the loader's ``process_index`` /
``process_count`` are its rank and the world; the device cache draws the
global batch and makes its rows), the train state follows the JAX ZeRO plan
(``fsdp_min_size``, default 2**18 elements) and a step equals one process's
on the global batch (``train.step``). ``validate`` and ``predict`` shard
each batch over the ranks (``_sample_batch``): every rank draws the whole
batch's x_T and per-step noise from the shared seeded generator, samples
its rows and gathers the others', which gives every rank one process's
result. A batch whose rows the ranks do not divide, and the samplers whose
arithmetic spans the batch (int8 serving's dynamic activation scale, the
adaptive DPM-Solver's step control), run whole on every rank. Logs, the
journal, image dumps, checkpoints and predicted volumes are written by
rank 0 alone, and every rank restores its shards from a checkpoint.

Random numbers: ``fit`` seeds a generator on the trainer's device for each
step from (seed, number of earlier ``fit`` calls of this trainer, step), so
a run resumed at step k in a new process repeats the draws of the run that
was not interrupted; ``validate`` starts every call from seed 0 and
``predict`` from the config's ``seed``. The loader's shuffle and
augmentation are numpy, keyed on (seed, epoch, index).
"""
from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from ..core import palette, process, sampling, schedules
from ..data import h5store
from ..data.npy_dataset import NpyCaseDataset
from ..data.pipeline import BatchLoader, SliceDataset
from ..eval.assemble import VolumeAssembler, evaluate_predictions
from ..models import build_model, make_cached_denoiser
from ..models.layers import hold_in_compute_dtype
from ..ops import quant
from ..parallel import dist as pdist
from ..parallel import mesh as pmesh
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.flax_bridge import flax_to_state_dict, train_state_from_flax
from ..utils.logging import KVLogger, journal
from ..utils.torch_io import load_sd_vae
from . import schedule_sampler as ss
from .checkpoints import CheckpointManager
from .config import Config
from .state import TrainState, cosine_lr, make_optimizer
from .step import (
    TaskConfig,
    draw_x_T,
    make_palette_sample_fn,
    make_palette_train_step,
    make_sample_fn,
    make_train_step,
    make_val_metrics,
    model_call,
    run_sampler_loop,
)

__all__ = ["Trainer", "FEATURE_KINDS", "OPENAI_SCHEDULE_MODES", "model_params",
           "io_channels"]

# net_mode -> (model registry key, feature kind)
FEATURE_KINDS = {
    "ds_diff_gaussian": ("dsunet", "ds"),
    "ds_diff": ("dsunet", "ds"),
    "ds_diff_split": ("dsunet_split", "ds"),
    "disc_diff": ("disc_unet", "disc"),
    "ddpm": ("unet", None),
    "dit": ("dit", None),
    "latent": ("unet", None),
    "palette": ("unet", None),
    "diffusion": ("unet", None),
}

# net_modes whose diffusion math follows the OpenAI fork: their 'linear'
# noise_schedule is our 'scaled_linear' and their non-learned variance is
# fixed_large. The LDM-math modes keep the sqrt-space 'linear' and the
# posterior variance.
OPENAI_SCHEDULE_MODES = frozenset(
    {"ds_diff_gaussian", "ds_diff_split", "disc_diff", "dit"}
)

# data_store -> the dataset class over it (same constructor, same rows)
DATA_STORES = {"h5": SliceDataset, "npy": NpyCaseDataset}

# the end of an epoch's batches
_END = object()

# unet_config keys that describe the reference's torch module, not ours
_DROPPED_MODEL_KEYS = (
    "image_size", "use_checkpoint", "legacy", "use_new_attention_order",
    "use_linear_in_transformer", "adm_in_channels", "context_dim",
    "num_classes", "in_channels", "out_channels",
)


def io_channels(cfg: Config, n_cond: int) -> tuple[int, int]:
    """The denoiser's input channels (noise + ``n_cond`` conditions) and its
    output channels before ``learn_sigma`` doubles them: one image channel
    each and ``output_ch`` out, or for ``latent`` the first stage's
    ``embed_dim`` latent channels each, in and out."""
    if cfg.get("net_mode") != "latent":
        return 1 + n_cond, int(cfg.get("output_ch", 1))
    z = int((cfg.get_path("first_stage.params", {}) or {}).get("embed_dim", 4))
    return z * (1 + n_cond), z


def model_params(cfg: Config, model_name: str, n_cond: int,
                 use_edge=False) -> dict:
    """``build_model``'s keyword arguments for a run config: the input
    channels (noise + ``n_cond`` conditions; for ``latent``, z latent
    channels each), the output channels (``output_ch``, or z for
    ``latent``, doubled by ``learn_sigma``), the compute dtype (bf16 over
    f32 master parameters unless ``bf16: false``; norms in f32) and, by
    model, as the JAX trainer builds it: for ``dit`` the ``ViT_config``
    sizes; for the U-Nets the ``unet_config`` parameters that describe this
    package's module and ``remat``, except ``disc_unet``, which takes one
    stream per input channel and no ``remat``."""
    in_ch, out_ch = io_channels(cfg, n_cond)
    out_ch *= 2 if bool(cfg.get("learn_sigma", False)) else 1
    dtype = torch.bfloat16 if cfg.get("bf16", True) else torch.float32
    if model_name == "dit":
        vit = dict(cfg.get_path("ViT_config.params", {}) or {})
        return dict(
            input_size=int(vit.get("input_size", cfg.get("image_size", 256))),
            patch_size=int(vit.get("patch_size", 8)),
            in_channels=in_ch, out_channels=out_ch, dtype=dtype,
            hidden_size=int(vit.get("hidden_size", 768)),
            depth=int(vit.get("depth", 12)),
            num_heads=int(vit.get("num_heads", 12)),
        )
    params = dict(cfg.get_path("unet_config.params", {}) or {})
    for drop in _DROPPED_MODEL_KEYS:
        params.pop(drop, None)
    if model_name == "disc_unet":
        return dict(params, n_streams=in_ch, out_channels=out_ch, dtype=dtype)
    if model_name in ("dsunet", "dsunet_split"):
        params.setdefault("model_channels", 96)
        params.setdefault("use_edge", bool(use_edge))
    return dict(params, in_channels=in_ch, out_channels=out_ch, dtype=dtype,
                remat=bool(cfg.get("remat", False)))


class _RowNoise:
    """The per-step noise of a sampling loop over rows ``lo:hi`` of a batch:
    item ``i`` draws step ``i``'s noise for the whole batch (shaped, typed
    and placed like ``x_T``, as the loops draw it) from ``generator`` and
    keeps the rows, so that the draws are one process's. Steps are read
    once each, in order."""

    def __init__(self, x_T: torch.Tensor, generator: torch.Generator,
                 lo: int, hi: int):
        self.like, self.generator, self.lo, self.hi = x_T, generator, lo, hi
        self.next = 0

    def __getitem__(self, i: int) -> torch.Tensor:
        if i != self.next:
            raise IndexError(f"noise of step {i} read out of order "
                             f"(next is {self.next})")
        self.next += 1
        x = self.like
        return torch.randn(x.shape, generator=self.generator, dtype=x.dtype,
                           device=x.device)[self.lo:self.hi]


def _step_seed(seed: int, fit_call: int, step: int, *stream: int) -> int:
    """The generator seed of train step ``step`` in ``fit`` call
    ``fit_call`` (and of another ``stream`` of that step's draws: 1, the
    device data cache's)."""
    words = np.random.SeedSequence([seed, fit_call, step, *stream]
                                   ).generate_state(2)
    return int(words[0]) << 32 | int(words[1])


class Trainer:
    """Builds the data, schedule, model, train state and samplers from a run
    config. ``device`` defaults to ``"cuda"``; ``mesh`` (a
    ``parallel.mesh.Mesh``) trains data-parallel with a ZeRO-sharded state
    (the module docstring). ``workdir`` (needed by
    ``fit``, ``validate`` and ``predict``) receives ``logs/`` (metrics as
    text, JSONL and CSV; the run journal ``log_txt.txt`` at its root),
    ``checkpoint/<step>/``, ``images/`` and ``predictions/``.

    - ``train_step(batch, generator=None, t=None, noise=None)`` takes one
      optimizer step on an NHWC batch ``{"target": [B,H,W,1], "image":
      [B,H,W,n_cond]}`` and returns the metrics (0-d tensors).
    - ``sample_fn(cond [B,H,W,n_cond], generator=None, x_T=None,
      noise=None)`` returns samples [B, H, W, output_ch] from the EMA
      weights, through a serving copy of the model whose weights are held
      in the compute dtype and refreshed from the EMA when it has changed.
      The sampler comes from ``sampler_setting`` (``sampler``,
      ``sample_steps``, ``ddim_eta``, and for the DPM-Solver family
      ``order``, ``method``, ``skip_type``, ``algorithm_type``);
      ``set_sampler`` changes it. ``ds_diff_split`` serves through the
      cached-condition sampler unless ``cached_cond_sampling`` is false.
      ``palette`` owns its sampler: DDIM-``sample_steps`` with ``ddim_eta``
      over the test gamma schedule for 'ddim', the ancestral loop over all
      its steps for any other name.
      For ``latent`` its conditions and samples are latents, and
      ``first_stage`` (a ``LatentAdapter``) encodes and decodes them.
    - ``sample_images(cond, generator=None, ...)``: a request in image
      space (``sample_fn`` itself but for ``latent``, whose conditions it
      encodes and whose sample it decodes).
    - ``progressive_denoise(cond, generator=None, x_T=None)``: DDIM with
      every step's x0 prediction kept (not for ``ds_diff_split`` and
      ``palette``).
    - ``val_metrics(pred, target, valid=None)``: SSIM, MAE, PSNR.
    - ``fit``, ``validate``, ``predict`` and ``ckpt`` (a
      ``CheckpointManager``): as the JAX package's.

    ``trace_spans: true`` turns the program's tracer on
    (``utils.profiling``); ``fit``'s log then adds ``train_batch_wait_ms``
    and ``train_to_device_ms``, the mean host ms a step spent taking its
    batch and moving it to the card.
    """

    def __init__(self, cfg: Mapping, workdir=None, device=None, mesh=None):
        cfg = Config.wrap(dict(cfg))
        self.cfg = cfg
        self.device = resolve_device(device or "cuda")
        self.mesh = mesh
        self.ranks = mesh.world if mesh is not None and mesh.distributed else 1
        self.rank = mesh.rank if self.ranks > 1 else 0
        self.is_main = pdist.is_main()
        if cfg.get("trace_spans", False):
            profiling.enable()
        self.workdir = self.logger = self.ckpt = None
        if workdir is not None:
            self.workdir = Path(workdir)
            self.workdir.mkdir(parents=True, exist_ok=True)
            self.logger = (KVLogger(self.workdir / "logs") if self.is_main
                           else KVLogger(None, formats=()))

        net_mode = cfg.get("net_mode", "ds_diff_gaussian")
        model_name, feature_kind = FEATURE_KINDS.get(net_mode, (net_mode, None))
        self.keys = list(cfg.get("train_keys",
                                 ["F_Data1", "F_Data2", "S_Data1", "S_Data2"]))
        self.use_edge = cfg.get("use_edge", False) or False

        # ---- data
        store = cfg.get("data_store", "h5")
        if store not in DATA_STORES:
            raise ValueError(f"unknown data_store '{store}' "
                             f"(have {sorted(DATA_STORES)})")
        self.dataset_cls = DATA_STORES[store]
        self.train_loader = self.val_loader = None
        n_cond = len(self.keys) - 1 + (1 if self.use_edge else 0)
        data_root = cfg.get("h5_2d_img_dir")
        if data_root:
            self._setup_data(data_root)
            n_cond = self.train_ds.image_channels()

        # ---- diffusion schedule
        T = int(cfg.get_path("diffusion.steps", cfg.get("diffusion_steps", 1000)))
        beta_schedule = cfg.get_path("diffusion.beta_schedule", None)
        if beta_schedule is None:
            # for the OpenAI-math pipelines 'linear' means
            # scale*linspace(1e-4, 2e-2), our 'scaled_linear'
            beta_schedule = cfg.get("noise_schedule", "linear")
            if beta_schedule == "linear" and net_mode in OPENAI_SCHEDULE_MODES:
                beta_schedule = "scaled_linear"
        self.betas = schedules.make_beta_schedule(
            beta_schedule, T, float(cfg.get("linear_start", 1e-4)),
            float(cfg.get("linear_end", 2e-2)),
        )
        self.sched = schedules.DiffusionSchedule.create(
            self.betas, device=self.device
        )

        learn_sigma = bool(cfg.get("learn_sigma", False))
        disen = cfg.get("disentangle_distance", "eu")
        loss_type = cfg.get("loss_type", "charbonnier")
        self.task = TaskConfig(
            parameterization=cfg.get("parameterization", "v"),
            variance_type=cfg.get(
                "variance_type",
                "fixed_large" if net_mode in OPENAI_SCHEDULE_MODES
                else "fixed_small",
            ),
            loss_type={"charbonnie": "charbonnier"}.get(loss_type, loss_type),
            learn_sigma=learn_sigma,
            feature_kind=feature_kind if disen else None,
            disentangle_mode=disen or "eu",
            disen_lambda=float(cfg.get("contrast_lambda", 0.5)),
            cond_dropout=float(cfg.get("cond_dropout", 0.0)),
            cfg_scale=float(
                (cfg.get("sampler_setting", {}) or {}).get("cfg_scale", 1.0)
            ),
        )

        # ---- first stage (latent pipeline)
        seed = int(cfg.get("seed", 2024))
        self.first_stage = None
        if net_mode == "latent":
            self.first_stage = self._build_first_stage()

        # ---- model
        self.in_ch, self.base_out = io_channels(cfg, n_cond)
        params = model_params(cfg, model_name, n_cond, self.use_edge)
        # modules initialise on the CPU from its default generator: seed it
        # for this build only
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(seed)
            self.model = build_model(model_name, device=self.device, **params)
        self.n_cond = n_cond
        self.model_name = model_name
        self.n_params = sum(p.numel() for p in self.model.parameters())
        if self.workdir is not None:
            self._journal(
                f"model {model_name}: {self.n_params / 1e6:.2f}M params")

        # ---- optimizer, EMA, schedule sampler; 1000 steps an epoch without
        # a loader, as the JAX trainer assumes
        steps_per_epoch = (len(self.train_loader) if self.train_loader
                           else 1000)
        lr = cosine_lr(
            float(cfg.get("lr", 1e-4)),
            int(cfg.get("num_epochs", 250)) * steps_per_epoch,
            warmup_steps=int(cfg.get("lr_warm_epoch", 0)) * steps_per_epoch,
            min_lr=float(cfg.get("lr_low", 1e-7)),
        )
        grad_clip = cfg.get("grad_clip", None)
        opt = dict(
            weight_decay=float(cfg.get("weight_decay", 0.0)),
            betas=(float(cfg.get("beta1", 0.9)), float(cfg.get("beta2", 0.999))),
            grad_clip=float(grad_clip) if grad_clip else None,
            accum_steps=int(cfg.get("accum_steps", 1)),
        )
        plan = None
        if mesh is not None:
            plan = pmesh.param_sharding(
                mesh, self.model, int(cfg.get("fsdp_min_size", 2**18)))
        self.state = TrainState(
            self.model, lambda params: make_optimizer(params, lr, **opt),
            ema_decay=float(cfg.get("ema_rate", 0.9999)), mesh=mesh,
            plan=plan,
        )
        self.sampler_state = ss.make_schedule_sampler(
            cfg.get("schedule_sampler", "uniform"), T, device=self.device
        )
        self.val_metrics = make_val_metrics()
        samp = cfg.get("sampler_setting", {}) or {}
        self.sample_steps = int(samp.get("sample_steps", 20))
        self.sampler_name = samp.get("sampler", "ddim")
        self.eta = float(samp.get("ddim_eta", 0.0))
        self.palette = net_mode in ("palette", "diffusion")
        if self.palette:
            self._setup_palette_schedules()
            self._train_step = make_palette_train_step(self.gs_train, mesh)
        else:
            self._train_step = make_train_step(self.task, self.sched, mesh)

        # ---- samplers over the EMA weights
        # the serving copy: compute-dtype weights, filled from the EMA
        self.sample_model = hold_in_compute_dtype(
            copy.deepcopy(self.model).requires_grad_(False)
        ).eval()
        self._sample_version = None
        # int8 serving (set_sampler): False, True (dynamic) or 'static'; the
        # static activation scales; the state version quantised last
        self.sample_int8: bool | str = False
        self._act_scales = None
        self._int8_version = None
        if bool(samp.get("ddim_use_original_steps", False)):
            self.rsched = self.sched
        else:
            self.rsched = self._respaced()
        self._build_sampler(
            model_name == "dsunet_split"
            and bool(cfg.get("cached_cond_sampling", True)), {}
        )

        if self.workdir is not None:
            self.ckpt = CheckpointManager(
                self.workdir / "checkpoint",
                max_to_keep=int(cfg.get("keep_checkpoints", 3)),
            )
        self.best_ssim = -1.0
        self._fit_calls = 0  # keys each fit call's step draws
        self.device_cache = None  # the train split on the card, once used

    def _build_first_stage(self):
        """The frozen ``AutoencoderKL`` of ``first_stage.params`` behind a
        ``LatentAdapter``: weights from the config's seed, then, where
        ``vae_checkpoint`` names a file (an SD / HF VAE checkpoint:
        safetensors or a zip pickle), that file key-mapped and shape-fit
        onto it (``utils.torch_io.load_sd_vae``; leaves the file lacks keep
        the seed's values), or where it names a directory ``VaeTrainer``
        wrote (its ``checkpoint/``), the raw (not EMA) parameters of its
        latest checkpoint."""
        from .latent import LatentAdapter
        from .vae_loop import build_vae

        cfg = self.cfg
        vae = build_vae(cfg, self.device)
        ckpt_path = cfg.get("vae_checkpoint")
        if ckpt_path and Path(ckpt_path).is_file():
            state, missing, _ = load_sd_vae(ckpt_path, vae)
            vae.load_state_dict(state)
            if self.workdir is not None:
                self._journal(f"vae init from {ckpt_path}: "
                              f"{len(missing)} params kept fresh")
        elif ckpt_path:
            vcm = CheckpointManager(ckpt_path, keep_best=False)
            vae.load_state_dict(vcm.restore_params(vae, ema=False))
            if self.workdir is not None:
                self._journal(f"vae restored from {ckpt_path} "
                              f"(step {vcm.latest_step()})")
        return LatentAdapter(
            vae, scale_factor=float(cfg.get("scale_factor", 0.18215)),
            scale_by_std=bool(cfg.get("scale_by_std", False)))

    # ------------------------------------------------------------------ data
    def _setup_data(self, data_root) -> None:
        cfg = self.cfg
        root = Path(data_root)
        image_size = int(cfg.get("image_size", 256))
        split = f"images_tr_{image_size}"
        cases = h5store.list_cases(root / split)
        val_split = cfg.get("val_split")  # BraTS variant: explicit val dir
        if val_split:
            train_cases = cases
            val_cases = None  # all cases of the explicit split
        else:
            fold_k = int(cfg.get("fold_K", 5))
            fold_idx = int(cfg.get("fold_idx", 1))
            train_cases, val_cases = h5store.kfold_split(
                cases, fold_k, fold_idx % fold_k,
                seed=int(cfg.get("seed", 2024)),
            )
        common = dict(root=root, split=split, keys=self.keys,
                      use_edge=self.use_edge)
        self.train_ds = self.dataset_cls(
            cases=train_cases, augment=True,
            aug_prob=float(cfg.get("augmentation_prob", 0.4)), **common,
        )
        if val_split:
            common["split"] = val_split
            self.val_ds = self.dataset_cls(cases=None, augment=False, **common)
            val_cases = self.val_ds.cases
        else:
            self.val_ds = self.dataset_cls(cases=val_cases, augment=False,
                                           **common)
        bs = int(cfg.get("train_batch_size", 8))
        vbs = int(cfg.get("val_batch_size", bs))
        if self.mesh is not None:
            n_data = self.mesh.shape["data"]
            if bs % n_data or vbs % n_data:
                raise ValueError(
                    f"batch sizes ({bs}, {vbs}) must be divisible by the mesh "
                    f"'data' axis ({n_data})")
        seed = int(cfg.get("seed", 2024))
        # each rank loads its rows of a train batch, and every val batch
        # whole
        self.train_loader = BatchLoader(self.train_ds, bs, seed=seed,
                                        shuffle=True, drop_last=True,
                                        process_count=self.ranks,
                                        process_index=self.rank)
        self.val_loader = BatchLoader(self.val_ds, vbs, seed=seed,
                                      shuffle=False, drop_last=False,
                                      process_count=1, process_index=0)
        if self.workdir is not None:
            self._journal(
                f"data: {len(train_cases)} train / {len(val_cases)} val "
                f"cases, {len(self.train_ds)} / {len(self.val_ds)} slices",
            )

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host batch array on the trainer's device; through pinned
        memory and an asynchronous copy on a card."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _journal(self, message: str) -> None:
        """A line in the run journal (rank 0 writes it)."""
        if self.is_main:
            journal(self.workdir, message)

    def _need_workdir(self, what: str) -> None:
        if self.workdir is None:
            raise ValueError(f"{what} needs a workdir")

    # ----------------------------------------------------------------- train
    def fit(self, num_epochs: int | None = None, max_steps: int | None = None,
            log_every: int = 50, val_every_epochs: int | None = None,
            val_on_done: bool = True) -> int:
        """Train from the state's step to ``num_epochs`` (default the
        config's) or ``max_steps``, validating and saving every
        ``val_every_epochs`` epochs (default ``val_step``) and, with
        ``val_on_done``, when ``max_steps`` ends the run. Returns the step.
        Batches reach the card through pinned memory while the loader's
        thread builds the next ones; with ``device_data_cache`` the split is
        held on the card (``data.device_cache``) and each step's batch is
        drawn, gathered and augmented there, an epoch being a window of
        ``len(train_loader)`` steps."""
        cfg = self.cfg
        self._need_workdir("fit")
        if self.train_loader is None:
            raise ValueError("no dataset configured (h5_2d_img_dir)")
        num_epochs = num_epochs or int(cfg.get("num_epochs", 250))
        val_every = val_every_epochs or int(cfg.get("val_step", 5))
        seed = int(cfg.get("seed", 2024))
        fit_call = self._fit_calls
        self._fit_calls += 1
        step = int(self.state.step)
        done = False
        # resume the epoch stream where the restored step left off: the
        # loader keys shuffle and augmentation on (seed, epoch, index)
        epoch0 = step // max(len(self.train_loader), 1)
        # shannon-entropy warm-up curriculum (trainer_use_gaussian_diff
        # :172-234 / train_util.py:217-228)
        curriculum = None
        warmup_steps = int(cfg.get("shannon_warmup_steps", 2000))
        if cfg.get("shannon", False):
            from ..data.curriculum import EntropyCurriculum

            curriculum = EntropyCurriculum(self.train_ds, seed=seed)
            self._np_rng = np.random.default_rng(seed)
        cache_fn = None
        if bool(cfg.get("device_data_cache", False)):
            if curriculum is not None:
                raise ValueError(
                    "device_data_cache is incompatible with the shannon "
                    "curriculum (host-side entropy buckets)")
            cache_fn = self._cache_batch_fn()
            cache_gen = torch.Generator(device=self.device)
            rows = (None if self.ranks == 1 else
                    self.mesh.local_rows(self.train_loader.batch_size))
        gen = torch.Generator(device=self.device)
        t_rate = time.time()
        steps_at_rate = step
        span_s = profiling.scope_totals()

        def epoch_batches(epoch):
            # without a loader the batch is made on the card below
            batches = iter(self.train_loader.epoch(epoch) if cache_fn is None
                           else [None] * len(self.train_loader))
            while True:
                with profiling.span("fit.batch_wait"):
                    batch = next(batches, _END)
                if batch is _END:
                    return
                yield batch

        for epoch in range(epoch0, num_epochs):
            t_ep = time.time()
            for batch in epoch_batches(epoch):
                if curriculum is not None and step < warmup_steps:
                    with profiling.span("fit.batch_wait"):
                        batch = curriculum.batch(
                            self.train_loader.batch_size, step, warmup_steps,
                            self._np_rng,
                        )
                with profiling.span("fit.to_device"):
                    if batch is None:
                        cache_gen.manual_seed(
                            _step_seed(seed, fit_call, step, 1))
                        dev_batch = cache_fn(cache_gen, rows)
                    else:
                        dev_batch = {k: self._to_device(batch[k])
                                     for k in ("image", "target")}
                gen.manual_seed(_step_seed(seed, fit_call, step))
                if self.first_stage is not None:
                    dev_batch = self.first_stage.encode_batch(dev_batch, gen)
                metrics = self.train_step(dev_batch, gen)
                step += 1
                if step % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t_rate
                    if dt > 0 and step > steps_at_rate:
                        m["steps_per_sec_per_chip"] = (
                            (step - steps_at_rate) / dt / self.ranks)
                    if profiling.enabled():
                        # host ms a step spent in each span since the last log
                        now = profiling.scope_totals()
                        for key, name in (("batch_wait_ms", "fit.batch_wait"),
                                          ("to_device_ms", "fit.to_device")):
                            m[key] = 1e3 * (now.get(name, 0.0)
                                            - span_s.get(name, 0.0)) / (
                                                step - steps_at_rate)
                        span_s = now
                    t_rate = time.time()
                    steps_at_rate = step
                    m["step"] = step
                    m["epoch"] = epoch
                    for k, v in m.items():
                        self.logger.logkv(
                            k if k.startswith(("step", "epoch"))
                            else f"train_{k}", v)
                    self.logger.dumpkvs()
                if max_steps and step >= max_steps:
                    done = True
                    break
            self._journal(f"epoch {epoch} done in {time.time() - t_ep:.1f}s "
                          f"(step {step})")
            if (epoch + 1) % val_every == 0 or (done and val_on_done):
                vm = self.validate(max_batches=int(
                    cfg.get("limit_val_batches", 8)))
                self.ckpt.save(step, self.state, self.sampler_state,
                               metrics={"val_ssim": vm["ssim"],
                                        "val_mae": vm["mae"]})
            if done:
                break
        return step

    def _cache_batch_fn(self):
        """The batch function, at the train batch size, of the device data
        cache of the train split (bf16 unless ``bf16: false``), uploaded at
        the first ``fit`` call and kept for the next ones."""
        from ..data.device_cache import DeviceCache

        cfg = self.cfg
        cache = self.device_cache
        if cache is None:
            cache = self.device_cache = DeviceCache.from_dataset(
                self.train_ds, device=self.device,
                dtype=torch.bfloat16 if cfg.get("bf16", True)
                else torch.float32)
            self._journal(f"device data cache: {cache.n} slices, "
                          f"{cache.images.dtype}")
        return cache.make_batch_fn(
            self.train_loader.batch_size, augment=bool(self.train_ds.augment),
            aug_prob=float(cfg.get("augmentation_prob", 0.4)))

    def _respaced(self) -> schedules.DiffusionSchedule:
        return schedules.respace(
            self.betas,
            schedules.space_timesteps(len(self.betas), str(self.sample_steps)),
            rescale_timesteps=bool(self.cfg.get("rescale_timesteps", False)),
            device=self.device,
        )

    def _setup_palette_schedules(self) -> None:
        """The Palette pipeline's train and test gamma schedules
        (``palette.train_schedule`` / ``test_schedule``)."""
        cfg = self.cfg
        train = dict(cfg.get_path("palette.train_schedule", {}) or {})
        test = dict(cfg.get_path("palette.test_schedule", {}) or {})
        self.gs_train = palette.GammaSchedule.create(
            n_timestep=int(train.get("n_timestep", 2000)),
            linear_start=float(train.get("linear_start", 1e-6)),
            linear_end=float(train.get("linear_end", 0.01)),
            device=self.device,
        )
        self.gs_test = palette.GammaSchedule.create(
            n_timestep=int(test.get("n_timestep", 1000)),
            linear_start=float(test.get("linear_start", 1e-4)),
            linear_end=float(test.get("linear_end", 0.09)),
            device=self.device,
        )

    def _build_sampler(self, cached: bool, solver_options: dict) -> None:
        """(Re)build ``_sample`` over ``rsched`` from the current sampler
        name, step count and eta; the progressive-denoise loop follows."""
        if self.palette:
            self._sample = make_palette_sample_fn(
                self.sample_model, self.gs_test, self.sampler_name,
                self.sample_steps, self.eta)
        elif cached:
            self._sample = self._make_cached_sample_fn(self.rsched)
        else:
            samp = self.cfg.get("sampler_setting", {}) or {}
            opts = {k: samp[k] for k in
                    ("order", "method", "skip_type", "algorithm_type")
                    if k in samp}
            opts.update(solver_options)
            self._sample = make_sample_fn(
                self.sample_model, self.rsched, self.task, self.sampler_name,
                self.eta,
                clip_denoised=bool(self.cfg.get("clip_denoised", True)),
                out_channels=self.base_out,
                full_sched=self.sched,
                sample_steps=self.sample_steps,
                solver_options=opts,
                patch_params=self.cfg.get("split_input_params"),
            )
        self._row_fn = self._make_denoise_row_fn()

    def set_sampler(self, sampler: str | None = None,
                    sample_steps: int | None = None,
                    ddim_eta: float | None = None,
                    cached: bool | None = None,
                    int8: bool | str | None = None,
                    **solver_options) -> None:
        """Rebuild the sampling path with new settings on a live trainer:
        evaluate ONE set of weights under ddim-50 / dpm-20 / cached-cond
        without building the trainer again. Arguments left ``None`` keep
        their value; ``cached`` defaults to the model's own kind (cached
        for ``ds_diff_split``). ``solver_options`` (order, method,
        skip_type, algorithm_type, ...) go to the DPM-Solver family on top
        of ``sampler_setting``'s.

        ``int8=True`` serves every eligible denoiser conv in int8
        (``ops.quant``: int8 weights per output channel, a dynamic int8
        activation scale per call); ``int8='static'`` first calibrates one
        activation scale per conv (``_calibrate_int8_scales``, on val
        batches) and uses it instead, except on the cached-condition
        sampler, which stays dynamic as in the JAX package; ``int8=False``
        serves in the compute dtype again. The weights are quantised from
        the f32 EMA when a request finds them moved, never per step."""
        if self.palette:
            raise ValueError("palette owns its own sampler")
        if int8 is not None:
            if int8 not in (True, False, "static"):
                raise ValueError(f"int8 must be True, False or 'static', "
                                 f"not {int8!r}")
            self.sample_int8 = "static" if int8 == "static" else bool(int8)
        if sampler is not None:
            self.sampler_name = sampler
        if sample_steps is not None:
            self.sample_steps = int(sample_steps)
        if ddim_eta is not None:
            self.eta = float(ddim_eta)
        self.rsched = self._respaced()
        # only the split model has a cache to serve from
        use_cached = self.model_name == "dsunet_split" and (
            cached is None or bool(cached))
        quant.dequantize_model(self.sample_model)
        self._act_scales = None
        if self.sample_int8 == "static" and not use_cached:
            self._act_scales = self._calibrate_int8_scales()
        self._int8_version = None  # quantised again at the next request
        self._build_sampler(use_cached, solver_options)

    @torch.no_grad()
    def _calibrate_int8_scales(self, n_batches: int = 2,
                               t_points=(25, 250, 500, 750, 975),
                               generator: torch.Generator | None = None,
                               noise=None) -> dict:
        """Static int8 calibration: each eligible conv's input max-abs over
        denoiser forwards of the EMA weights on the first ``n_batches`` val
        batches, noised to each of ``t_points``; returns ``{conv name:
        scale}`` for ``quant.quantize_model``. The noise comes from
        ``generator`` (default: seeded 17 on the trainer's device), one
        draw per (batch, t) in that order, or from the list ``noise``."""
        if self.val_loader is None:
            raise ValueError("int8 calibration needs val data (h5_2d_img_dir)")
        self._refresh_sample_model()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(17)
        T = len(self.betas)
        draws = iter(noise) if noise is not None else None
        inputs = []
        for i, batch in enumerate(self.val_loader.epoch(0)):
            if i >= n_batches:
                break
            cond = self._to_device(batch["image"])
            x0 = self._to_device(batch["target"])
            for t in t_points:
                tt = torch.full((x0.shape[0],), min(int(t), T - 1),
                                dtype=torch.long, device=self.device)
                eps = (next(draws).to(self.device) if draws is not None
                       else torch.randn(x0.shape, generator=generator,
                                        device=self.device))
                x_t = process.q_sample(self.sched, x0, tt, eps)
                inputs.append((torch.cat([x_t, cond], dim=-1), tt.float()))
        return quant.calibrate_act_scales(self.sample_model, inputs)

    def _make_cached_sample_fn(self, rsched):
        """DSUNetSplit: the condition encoders run once per sample call
        (``models/dsunet_cached.py``); a step is the noise encoder and the
        trunk. Serves 'dpm++' / 'dpm_solver++', 'plms', 'ancestral' /
        'ddpm', and DDIM for any other sampler name, as the JAX package
        does."""
        model = self.sample_model
        task = self.task
        eta = self.eta
        clip = bool(self.cfg.get("clip_denoised", True))
        out_ch = self.base_out
        loop = sampling.SAMPLERS.get(self.sampler_name,
                                     sampling.ddim_sample_loop)

        @torch.inference_mode()
        def fn(cond, generator=None, x_T=None, noise=None):
            denoise = model_call(make_cached_denoiser(model, cond))
            if x_T is None:
                x_T = draw_x_T(cond, out_ch, generator)
            return run_sampler_loop(loop, rsched, denoise, x_T, task, eta,
                                    clip, generator, noise)

        return fn

    def _make_denoise_row_fn(self):
        """DDIM over ``rsched`` that keeps every step's x0 prediction;
        ``None`` for ``ds_diff_split`` (the cached-condition sampler has its
        own closure) and for ``palette`` (its denoiser is conditioned on
        gamma, not on ``rsched``'s timesteps; the JAX package's image dump
        skips its row too)."""
        if self.cfg.get("net_mode") == "ds_diff_split" or self.palette:
            return None
        model = self.sample_model
        task = self.task
        rsched = self.rsched
        out_ch = self.base_out
        clip = bool(self.cfg.get("clip_denoised", True))

        @torch.inference_mode()
        def fn(cond, generator=None, x_T=None):
            if x_T is None:
                x_T = draw_x_T(cond, out_ch, generator)

            def denoise(x, t_model):
                out = model(torch.cat([x, cond], dim=-1), t_model)
                return out[0] if isinstance(out, tuple) else out

            _, x0s = sampling.ddim_sample_loop(
                rsched, denoise, x_T,
                parameterization=task.parameterization,
                learn_sigma=task.learn_sigma, clip_denoised=clip,
                collect_x0=True,
            )
            return x0s

        return fn

    def _refresh_sample_model(self) -> None:
        """Bring the serving copy up to the EMA weights if they moved, and
        under int8 serving its int8 weights too."""
        if self._sample_version != self.state.version:
            with torch.no_grad():
                ema = self.state.ema_state_dict()
                for name, p in self.sample_model.named_parameters():
                    p.copy_(ema[name])
            self._sample_version = self.state.version
        if self.sample_int8 and self._int8_version != self.state.version:
            quant.quantize_model(self.sample_model, self.state.ema_state_dict(),
                                 act_scales=self._act_scales)
            self._int8_version = self.state.version

    def sample_fn(self, cond: torch.Tensor,
                  generator: torch.Generator | None = None,
                  x_T: torch.Tensor | None = None,
                  noise=None) -> torch.Tensor:
        """Samples [B, H, W, output_ch] from the EMA weights. ``x_T`` and a
        stochastic sampler's per-step ``noise`` (a list, one tensor per
        step) are drawn from ``generator`` unless given."""
        with profiling.span("serve.request", batch=cond.shape[0],
                            steps=self.sample_steps):
            self._refresh_sample_model()
            return self._sample(cond, generator, x_T, noise)

    def sample_images(self, cond: torch.Tensor,
                      generator: torch.Generator | None = None,
                      cond_noise=None, **draws) -> torch.Tensor:
        """A request in image space, [B, H, W, n_cond] conditions ->
        [B, H, W, output_ch] samples: ``sample_fn`` (``draws``: its
        ``x_T`` and ``noise``), and for ``latent`` the conditions encoded
        first (posterior draws ``cond_noise``, one per condition, or from
        ``generator``) and the sampled latents decoded after."""
        if self.first_stage is not None:
            cond = self.first_stage.encode_cond(cond, generator, cond_noise)
        out = self.sample_fn(cond, generator, **draws)
        if self.first_stage is not None:
            return self.first_stage.decode_batch(out)
        return out

    def _sample_batch(self, cond: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
        """``sample_images`` of a whole batch, which under a distributed
        mesh each rank samples only its rows of: the conditions' encoding
        (``latent``), x_T and every per-step noise are drawn for the whole
        batch from ``generator``, as one process draws them, and the rows
        are gathered after. Whole on every rank where the ranks do not
        divide the rows, under int8 serving and for 'dpm_adaptive'."""
        B = cond.shape[0]
        if (self.ranks == 1 or B % self.ranks or self.sample_int8
                or self.sampler_name == "dpm_adaptive"):
            return self.sample_images(cond, generator)
        lo, hi = self.mesh.local_rows(B)
        if self.first_stage is not None:
            cond = self.first_stage.encode_cond(cond, generator)
        if self.palette:  # core.palette's start: one channel
            x_T = draw_x_T(cond, 1, generator)
        else:
            x_T = draw_x_T(cond, self.base_out, generator)
        out = self.sample_fn(cond[lo:hi], generator, x_T=x_T[lo:hi],
                             noise=_RowNoise(x_T, generator, lo, hi))
        if self.first_stage is not None:
            out = self.first_stage.decode_batch(out)
        return pdist.all_gather_rows(out)

    def progressive_denoise(self, cond: torch.Tensor,
                            generator: torch.Generator | None = None,
                            x_T: torch.Tensor | None = None, cond_noise=None):
        """Sample by DDIM (eta 0) with the intermediate x0 predictions
        collected along the chain. Returns (final [B,H,W,C], intermediates
        [T,B,H,W,C]); the final is the last intermediate. For ``latent``
        the conditions are encoded first (draws ``cond_noise`` or from
        ``generator``), the intermediates stay latents and the final is
        decoded."""
        if self._row_fn is None:
            raise RuntimeError(
                "progressive denoising is unavailable for this net_mode"
            )
        self._refresh_sample_model()
        if self.first_stage is not None:
            cond = self.first_stage.encode_cond(cond, generator, cond_noise)
        with quant.suspended(self.sample_model):
            frames = self._row_fn(cond, generator, x_T)
        if self.first_stage is not None:
            return self.first_stage.decode_batch(frames[-1]), frames
        return frames[-1], frames

    # ------------------------------------------------------------------- val
    def validate(self, max_batches: int = 8) -> dict:
        """Sample the first ``max_batches`` validation batches from the EMA
        weights (the generator seeded 0 at every call), average SSIM, MAE
        and PSNR over the valid rows of each batch and over the batches,
        log them and, with ``log_images`` (default on), dump the first
        batch's images."""
        self._need_workdir("validate")
        if self.val_loader is None:
            raise ValueError("no dataset configured (h5_2d_img_dir)")
        gen = torch.Generator(device=self.device).manual_seed(0)
        tot = {"ssim": 0.0, "mae": 0.0, "psnr": 0.0}
        n = 0
        first = None
        for i, batch in enumerate(self.val_loader.epoch(0)):
            if i >= max_batches:
                break
            pred = self._sample_batch(self._to_device(batch["image"]), gen)
            m = self.val_metrics(pred, self._to_device(batch["target"]),
                                 self._to_device(batch["valid"]))
            for k in tot:
                tot[k] += float(m[k])
            n += 1
            if first is None:
                first = (batch, pred.float().cpu().numpy())
        out = {k: v / max(n, 1) for k, v in tot.items()}
        for k, v in out.items():
            self.logger.logkv(f"val_{k}", v)
        self.logger.dumpkvs()
        self._journal(f"val ssim {out['ssim']:.4f} mae {out['mae']:.4f} "
                      f"psnr {out['psnr']:.2f}")
        if (first is not None and self.is_main
                and self.cfg.get("log_images", True)):
            try:
                self._log_images(*first)
            except Exception as e:  # image dumps never stop training
                self._journal(f"image logging failed: {e!r}")
        return out

    def _log_images(self, batch: dict, pred: np.ndarray) -> None:
        """Per-validation image dumps under <workdir>/images/step_<n>: the
        sample grid, the progressive-denoise row and the disentangle
        heatmaps (trainer_ds_diff.py:649-696, 771-789)."""
        from ..eval import visualize as V

        out_dir = self.workdir / "images" / f"step_{int(self.state.step):07d}"
        V.image_grid({"cond": batch["image"], "target": batch["target"],
                      "pred": pred}, out_dir / "samples.png")
        if self._row_fn is not None:
            gen = torch.Generator(device=self.device).manual_seed(2)
            _, frames = self.progressive_denoise(
                self._to_device(batch["image"]), gen)
            if self.first_stage is not None:
                frames = torch.stack([self.first_stage.decode_batch(f)
                                      for f in frames])
            V.denoise_row(frames.float().cpu().numpy(),
                          out_dir / "denoise_row.png")
        if self.task.feature_kind == "ds":
            feats = self._val_features(batch)
            if feats is not None:
                V.disentangle_heatmaps(feats, out_dir)

    @torch.inference_mode()
    def _val_features(self, batch: dict):
        """One noised forward of the EMA weights at t = T/2 (noise seeded
        3) for the DSUNet feature dict of the heatmap dump
        (trainer_use_gaussian_diff.py:472-475); None for a model without
        one, and for ``latent``."""
        if self.first_stage is not None:
            return None
        self._refresh_sample_model()
        target = self._to_device(batch["target"])
        cond = self._to_device(batch["image"])
        t = torch.full((target.shape[0],), self.sched.num_timesteps // 2,
                       dtype=torch.long, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(3)
        noise = torch.randn(target.shape, generator=gen, device=self.device)
        xt = process.q_sample(self.sched, target, t, noise)
        with quant.suspended(self.sample_model):
            out = self.sample_model(torch.cat([xt, cond], dim=-1),
                                    process.model_timestep(self.sched, t))
        if isinstance(out, tuple) and isinstance(out[1], dict):
            return out[1]
        return None

    # --------------------------------------------------------------- predict
    def predict(self, out_dir=None, split: str | None = None,
                template_root=None, gt_root=None, gt_name: str | None = None):
        """Sample every test slice (``images_ts_<size>`` unless ``split``)
        from the EMA weights, assemble one NIfTI volume per case under
        ``out_dir`` (default <workdir>/predictions) on the template's grid
        where ``template_root/<case>/<gt_name>`` exists, and, with
        ``gt_root``, score each against its ground truth into
        ``metrics.csv`` (inference_2d_with_gaussian_main parity). Returns
        (out_dir, metric rows)."""
        cfg = self.cfg
        if out_dir is None:
            self._need_workdir("predict without out_dir")
            out_dir = self.workdir / "predictions"
        out_dir = Path(out_dir)
        image_size = int(cfg.get("image_size", 256))
        test_ds = self.dataset_cls(
            root=Path(cfg.get("h5_2d_img_dir")),
            split=split or f"images_ts_{image_size}", keys=self.keys,
            use_edge=self.use_edge, augment=False,
        )
        loader = BatchLoader(test_ds, int(cfg.get("val_batch_size", 8)),
                             shuffle=False, drop_last=False, process_count=1,
                             process_index=0)
        asm = VolumeAssembler(out_dir, task_id=str(cfg.get("Task_id", "task")))
        gen = torch.Generator(device=self.device).manual_seed(
            int(cfg.get("seed", 2024)))
        for batch in loader.epoch(0):
            pred = self._sample_batch(self._to_device(batch["image"]), gen)
            asm.add_batch(batch["case"], batch["slice"],
                          pred.float().cpu().numpy(), batch["valid"])
        gt_file = gt_name or f"{self.keys[-1]}.nii.gz"
        if not self.is_main:  # rank 0 writes the volumes and the report
            pdist.sync_hosts()
            return out_dir, []
        for case in asm.cases():
            template = None
            if template_root:
                cand = Path(template_root) / case / gt_file
                if cand.exists():
                    template = cand
            asm.write_case(case, template)
        rows = []
        if gt_root:
            rows = evaluate_predictions(out_dir, gt_root, gt_file,
                                        report_path=out_dir / "metrics.csv")
        pdist.sync_hosts()
        return out_dir, rows

    def train_step(self, batch: Mapping[str, torch.Tensor],
                   generator: torch.Generator | None = None,
                   t: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None) -> dict:
        """One optimizer step; returns the metrics as 0-d f32 tensors."""
        with profiling.span("train.step"):
            _, self.sampler_state, metrics = self._train_step(
                self.state, self.sampler_state, batch, generator, t, noise
            )
        return metrics

    def reset_state(self) -> None:
        """Restart training from the model's current weights: step 0, fresh
        optimizer moments, EMA = weights. Call it after writing the model's
        parameters directly."""
        self.state.reset()

    def load_flax_params(self, tree: Mapping) -> None:
        """Load a Flax param tree (nested dicts of numpy arrays) through the
        layout bridge and restart the train state from it; raises on any
        missing or unused key."""
        self.model.load_state_dict(flax_to_state_dict(tree, self.model))
        self.reset_state()

    def load_flax_state(self, tree: Mapping, sampler: Mapping | None = None):
        """Continue a run of the JAX package. ``tree`` is the training state
        as ``utils.flax_bridge.train_state_from_flax`` takes it; ``sampler``,
        when given, holds the schedule sampler's ``kind``, ``loss_history``
        and ``loss_counts`` as numpy."""
        self.state.load(**train_state_from_flax(tree, self.model))
        if sampler is not None:
            dev = self.state.ema[0].device
            self.sampler_state = ss.SamplerState(
                str(sampler["kind"]),
                torch.as_tensor(np.asarray(sampler["loss_history"], np.float32),
                                device=dev),
                torch.as_tensor(np.asarray(sampler["loss_counts"], np.int32),
                                device=dev),
            )
