"""Checkpoints and gradient accumulation in the port, on the CPU (TINY
DSUNet, f32):

- a run cut after epoch 1, restored into a new trainer and resumed by
  ``fit`` ends bit for bit where the uninterrupted run does (parameters,
  EMA, AdamW moments, counters, sampler buffers), so the next step after
  the restore equals the uninterrupted one;
- retention keeps the best N by ``val_ssim`` plus the latest;
- a checkpoint of one encoder stream layout restores into the other;
- ``accum_steps`` 2 against ``optax.MultiSteps`` in the JAX package's
  ``TrainState``, on the same gradients: 1e-6 absolute (the same f32
  arithmetic, summed in another order by XLA);
- ``fit`` takes the shannon curriculum's batches for its warm-up steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dsdiff_tpu.train import state as JState
from dsdiff_torch.data import synthetic
from dsdiff_torch.train import state as PState
from dsdiff_torch.train.checkpoints import CheckpointManager
from dsdiff_torch.train.trainer import Trainer
from torch_parity_utils import TINY, one_thread, tiny_cfg

pytestmark = pytest.mark.usefixtures("one_thread")

KEYS = ["A", "B", "C", "GT"]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    # 5 cases: 1 test, and with fold_K 2 two train cases (4 slices, 2
    # batches of 2) and two validation cases
    synthetic.make_structured_dataset(root, n_cases=5, n_slices=2, hw=16,
                                      seed=0, store="npy")
    return root


def _cfg(store, **kw):
    cfg = tiny_cfg()
    cfg.update(h5_2d_img_dir=str(store), data_store="npy", image_size=16,
               train_keys=KEYS, train_batch_size=2, val_batch_size=2,
               fold_K=2, fold_idx=0, limit_val_batches=1, log_images=False,
               **kw)
    return cfg


def _assert_same_state(a: Trainer, b: Trainer):
    sa, sb = a.state.state_dict(), b.state.state_dict()
    assert sa.keys() == sb.keys()
    for k, v in sa.items():
        if isinstance(v, dict):
            for n, t in v.items():
                assert torch.equal(t, sb[k][n]), f"{k}/{n}"
        else:
            assert v == sb[k], k
    for buf in ("loss_history", "loss_counts"):
        assert torch.equal(getattr(a.sampler_state, buf),
                           getattr(b.sampler_state, buf))


def test_resumed_fit_equals_the_uninterrupted_run_bit_for_bit(store, tmp_path):
    cfg = _cfg(store, schedule_sampler="loss-second-moment")
    whole = Trainer(cfg, tmp_path / "whole", device="cpu")
    assert len(whole.train_loader) == 2
    assert whole.fit(num_epochs=2, log_every=1, val_every_epochs=1) == 4
    assert whole.ckpt.all_steps() == [2, 4]

    cut = Trainer(cfg, tmp_path / "cut", device="cpu")
    assert cut.fit(num_epochs=1, log_every=1, val_every_epochs=1) == 2
    resumed = Trainer(cfg, tmp_path / "cut", device="cpu")
    resumed.state, resumed.sampler_state = resumed.ckpt.restore(
        resumed.state, resumed.sampler_state)
    _assert_same_state(cut, resumed)
    assert resumed.fit(num_epochs=2, log_every=1, val_every_epochs=1) == 4
    _assert_same_state(whole, resumed)
    # the serving copy follows the restored EMA
    ema = resumed.state.ema_state_dict()
    resumed.sample_fn(torch.zeros(1, 32, 32, 3))
    for name, p in resumed.sample_model.named_parameters():
        assert torch.equal(p, ema[name])


def test_retention_keeps_the_best_by_val_ssim_and_the_latest(tmp_path):
    trainer = Trainer(tiny_cfg(), device="cpu")
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    for step, ssim in enumerate([0.5, 0.9, 0.1, 0.8, 0.2], start=1):
        mgr.save(step, trainer.state, trainer.sampler_state,
                 metrics={"val_ssim": ssim, "val_mae": 1.0 - ssim})
    assert mgr.all_steps() == [2, 4, 5]
    assert mgr.best_step() == 2 and mgr.latest_step() == 5
    assert not list((tmp_path / "ckpt").glob("*.tmp"))
    mgr.save(6, trainer.state)  # no metrics rank below every saved one
    assert mgr.all_steps() == [2, 4, 6]
    latest = CheckpointManager(tmp_path / "latest", max_to_keep=2,
                               keep_best=False)
    for step in range(1, 5):
        latest.save(step, trainer.state, metrics={"val_ssim": 1.0 / step})
    assert latest.all_steps() == [3, 4] and latest.best_step() is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore_params(trainer.model)


@pytest.mark.parametrize("save_mode, load_mode", [("sequential", "vmap"),
                                                  ("vmap", "sequential")])
def test_restore_converts_the_stream_layout(tmp_path, save_mode, load_mode):
    def trainer(mode):
        cfg = tiny_cfg()
        cfg["unet_config"] = {"params": dict(TINY, stream_mode=mode)}
        return Trainer(cfg, tmp_path / mode, device="cpu")

    src, dst = trainer(save_mode), trainer(load_mode)
    rng = np.random.default_rng(0)
    batch = {"target": torch.from_numpy(
                 rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)),
             "image": torch.from_numpy(
                 rng.standard_normal((2, 16, 16, 3)).astype(np.float32))}
    src.train_step(batch, torch.Generator().manual_seed(0))
    src.ckpt.save(1, src.state, src.sampler_state)
    dst.ckpt = src.ckpt
    assert set(src.state.names) != set(dst.state.names)
    dst.state, dst.sampler_state = dst.ckpt.restore(dst.state,
                                                    dst.sampler_state)
    assert dst.state.step == 1 and dst.state.tx.count == 1
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 4)).astype(np.float32))
    t = torch.tensor([300.0])
    with torch.no_grad():
        want, _ = src.model.eval()(x, t)
        got, _ = dst.model.eval()(x, t)
        assert torch.equal(got, want)
        dst.model.load_state_dict(dst.ckpt.restore_params(dst.model, ema=True))
        ema_out, _ = dst.model(x, t)
        src.model.load_state_dict(src.state.ema_state_dict())
        assert torch.equal(ema_out, src.model(x, t)[0])


def test_accumulation_matches_optax_multisteps():
    rng = np.random.default_rng(5)
    model = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2))
    names = [n for n, _ in model.named_parameters()]
    init = {n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
            for n, p in model.named_parameters()}
    model.load_state_dict({n: torch.from_numpy(v) for n, v in init.items()})
    lr = PState.cosine_lr(1e-2, 10, warmup_steps=2, min_lr=1e-5)
    port = PState.TrainState(model, lambda ps: PState.make_optimizer(
        ps, lr, weight_decay=0.01, grad_clip=0.5, accum_steps=2),
        ema_decay=0.99)
    jlr = JState.cosine_lr(1e-2, 10, warmup_steps=2, min_lr=1e-5)
    jtx = JState.make_optimizer(jlr, weight_decay=0.01, grad_clip=0.5,
                                accum_steps=2)
    jstate = JState.TrainState.create(None, {n: jnp.asarray(v) for n, v in
                                             init.items()}, jtx, ema_decay=0.99)
    before = [p.detach().clone() for p in port.params]
    for call in range(6):
        grads = {n: rng.standard_normal(v.shape).astype(np.float32) * 3
                 for n, v in init.items()}
        port.apply_gradients([torch.from_numpy(grads[n]) for n in names])
        jstate = jstate.apply_gradients({n: jnp.asarray(g)
                                         for n, g in grads.items()})
        adam = jstate.opt_state.inner_opt_state[-1][0]
        assert port.step == int(jstate.step) == call + 1
        assert port.tx.count == int(adam.count) == (call + 1) // 2
        assert port.tx.mini_step == int(jstate.opt_state.mini_step)
        for i, n in enumerate(names):
            for got, want in ((port.params[i], jstate.params[n]),
                              (port.ema[i], jstate.ema_params[n]),
                              (port.tx.mu[i], adam.mu[n]),
                              (port.tx.nu[i], adam.nu[n]),
                              (port.tx.acc[i], jstate.opt_state.acc_grads[n])):
                np.testing.assert_allclose(got.detach().numpy(),
                                           np.asarray(want), rtol=0, atol=1e-6,
                                           err_msg=f"call {call} {n}")
        if call == 0:  # no update on the first of two calls
            assert all(torch.equal(a, p) for a, p in zip(before, port.params))
    assert jax.tree.leaves(jstate.params)  # the JAX state moved as well


def test_fit_draws_from_the_shannon_curriculum_for_its_warmup(store, tmp_path,
                                                              monkeypatch):
    from dsdiff_torch.data import curriculum

    steps = []
    batch = curriculum.EntropyCurriculum.batch

    def counted(self, batch_size, step, warmup_steps, rng):
        steps.append(step)
        return batch(self, batch_size, step, warmup_steps, rng)

    monkeypatch.setattr(curriculum.EntropyCurriculum, "batch", counted)
    trainer = Trainer(_cfg(store, shannon=True, shannon_warmup_steps=3),
                      tmp_path, device="cpu")
    assert trainer.fit(num_epochs=2, log_every=2, val_every_epochs=5,
                       val_on_done=False) == 4
    assert steps == [0, 1, 2]
    assert trainer.ckpt.all_steps() == []  # no validation epoch came
