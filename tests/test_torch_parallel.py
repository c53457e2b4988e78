"""Data-parallel and ZeRO training (``dsdiff_torch.parallel``,
``Trainer(..., mesh=...)``) on gloo ranks, against one process of the port
and the JAX package's mesh, on the CPU.

The ranks are subprocesses (``tests/torch_dist_worker.py``, no JAX) over a
``file://`` store. One flagship train step on the ``TINY`` DSUNet with the
euclidean disentangle loss, the loss-second-moment sampler and an active
global-norm clip, given explicit t and noise for a global batch of 4, at
(data=2, fsdp=1) and (data=2, fsdp=2) with ``fsdp_min_size`` 4096 (so that
the wide kernels are split):

- against one process of the port: the loss within 1e-5 relative; both
  AdamW moments within 1e-5 of their leaf's largest magnitude, a leaf's
  scale being at least 1e-2 of the model's largest (some leaves have no
  gradient in exact arithmetic, a conv bias that feeds a GroupNorm with one
  channel per group, and hold rounding noise only); the updated parameters and EMA within
  1e-5 of the leaf's largest on the elements whose gradient is at least
  1e-2 of the leaf's largest and 1e-6 (Adam moves an element by about ±lr
  whatever its gradient, so where the gradient is rounding noise the sum's
  order picks the sign); the sampler's loss history within 1e-5 relative.
- against JAX's ``make_train_step`` on a (2, 2) mesh of CPU devices, within
  ``test_torch_train_step.py``'s tolerances (metrics 1e-4 relative,
  gradients 1e-4 of their leaf's scale, parameters and EMA 1e-6 absolute
  on the same elements).
- the same step with the cross-rank feature gather removed (each rank's
  disentangle loss over its own rows, averaged) must fail the comparison.

Per-rank state bytes and ``sharded_byte_fraction`` equal JAX's
``state_sharding``; a checkpoint written by 4 ranks restores in one process
bit for bit, and 4 ranks restore one process's bit for bit; ``validate``
under 2 ranks gives one process's metrics; ``BatchLoader`` rows per rank
are JAX's; ``python -m dsdiff_torch.cli.train`` under two gloo ranks
trains, saves and resumes.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dsdiff_tpu.core import schedules as JSch
from dsdiff_tpu.data import synthetic as JSyn
from dsdiff_tpu.data.pipeline import BatchLoader as JBatchLoader
from dsdiff_tpu.data.pipeline import SliceDataset as JSliceDataset
from dsdiff_tpu.models.dsunet import DSUNet as JDSUNet
from dsdiff_tpu.parallel import mesh as JMesh
from dsdiff_tpu.train import schedule_sampler as JSS
from dsdiff_tpu.train import state as JState
from dsdiff_tpu.train import step as JStep
from dsdiff_torch.data.pipeline import BatchLoader, SliceDataset
from dsdiff_torch.parallel import mesh as pmesh
from dsdiff_torch.train.checkpoints import CheckpointManager
from dsdiff_torch.train.trainer import Trainer
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import TINY, one_thread, random_flax_params, tiny_cfg

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
KEYS = ["A", "B", "C", "GT"]
B = 4  # the global batch
MIN_SIZE = 4096  # fsdp_min_size: TINY's wide kernels are split
CLIP = 0.05
PORT_RTOL = 1e-5  # ranks against one process of the port
JAX_RTOL = 1e-4  # against JAX, as test_torch_train_step.py
JAX_GRAD_TOL = 1e-4
NOISE_FLOOR = 1e-2
FIRM = 1e-2
JAX_PARAM_ATOL = 1e-6
TIMEOUT = 240


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("par")
    JSyn.make_structured_dataset(root / "data", n_cases=4, n_slices=2, hw=16,
                                 seed=0)
    return root


def _cfg(store):
    cfg = tiny_cfg(2)
    cfg.update(h5_2d_img_dir=str(store / "data"), image_size=16,
               train_keys=KEYS, train_batch_size=B, val_batch_size=2,
               fold_K=2, fold_idx=0, limit_val_batches=1, log_images=False,
               schedule_sampler="loss-second-moment", grad_clip=CLIP,
               fsdp_min_size=MIN_SIZE)
    return cfg


def _flax_params(seed=5):
    jm = JDSUNet(in_channels=4, out_channels=2, remat=True, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
                     jnp.zeros((1,)))["params"]
    return jm, random_flax_params(params, seed)


@pytest.fixture(scope="module")
def reference(store, tmp_path_factory):
    """W0 (a 1-process checkpoint of seeded weights), the global batch with
    JAX's draws of t and noise, one process of the port from W0 (its
    validation and its state after the step) and JAX's step on a (2, 2)
    mesh."""
    tmp = tmp_path_factory.mktemp("ref")
    cfg = _cfg(store)
    jm, params = _flax_params()
    one = Trainer(cfg, tmp / "one", device="cpu")
    one.load_flax_params({"params": params})
    w0 = CheckpointManager(tmp / "w0")
    w0.save(0, one.state, one.sampler_state)
    w0_state = {k: ({n: t.clone() for n, t in v.items()}
                    if isinstance(v, dict) else v)
                for k, v in one.state.state_dict().items()}
    val = one.validate(max_batches=1)

    rng = np.random.default_rng(21)
    batch = {"target": rng.uniform(-1, 1, (B, 16, 16, 1)).astype(np.float32),
             "image": rng.standard_normal((B, 16, 16, 3)).astype(np.float32)}
    key = jax.random.PRNGKey(3)
    t_rng, n_rng, _, _ = jax.random.split(jax.random.fold_in(key, 0), 4)
    sampler = JSS.loss2_init(1000)
    t, _ = JSS.sample_t(sampler, t_rng, B)
    noise = jax.random.normal(n_rng, batch["target"].shape, jnp.float32)
    batch["t"] = np.array(t, np.int64)
    batch["noise"] = np.array(noise)
    np.savez(tmp / "batch.npz", **batch)

    before_mu = [m.clone() for m in one.state.tx.mu]
    metrics = one.train_step({k: torch.from_numpy(batch[k])
                              for k in ("image", "target")},
                             t=torch.from_numpy(batch["t"]),
                             noise=torch.from_numpy(batch["noise"]))
    assert float(metrics["grad_norm"]) > CLIP  # the clip is active
    assert all(not m.any() for m in before_mu)

    # JAX: the same step on a (2, 2) mesh, the state ZeRO-sharded
    mesh = JMesh.make_mesh(2, 2, devices=jax.devices()[:4])
    lr = JState.cosine_lr(1e-4, 250 * len(one.train_loader), min_lr=1e-7)
    state = JState.TrainState.create(
        jm.apply, {"params": params},
        JState.make_optimizer(lr, grad_clip=CLIP), ema_decay=0.9999)
    shardings = JMesh.state_sharding(mesh, state, MIN_SIZE)
    state = jax.device_put(state, shardings)
    rep = NamedSharding(mesh, P())
    sampler = jax.device_put(sampler, rep)
    jbatch = {k: jax.device_put(jnp.asarray(batch[k]),
                                NamedSharding(mesh, P("data")))
              for k in ("image", "target")}
    task = JStep.TaskConfig(**dataclasses.asdict(one.task))
    sched = JSch.DiffusionSchedule.create(
        JSch.make_beta_schedule("scaled_linear", 1000))
    step_fn = JStep.make_train_step(task, sched, donate=False)
    jstate, jsampler, jmetrics = step_fn(state, sampler, jbatch, key)
    return dict(tmp=tmp, cfg=cfg, params=params, w0=w0.directory,
                w0_state=w0_state, val=val, batch=tmp / "batch.npz",
                one=one, metrics={k: float(v) for k, v in metrics.items()},
                mesh=mesh, jstate=jstate, jsampler=jsampler,
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                jstate0=state, shardings=shardings)


def _launch(spec: dict, world: int, out: Path, env=None, argv=None):
    """Run ``world`` ranks to their end; each rank's output goes to
    ``out/rank<r>.log``."""
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for rank in range(world):
        log = open(out / f"rank{rank}.log", "w")
        if argv is None:
            spec_path = out / "spec.json"
            spec_path.write_text(json.dumps(spec))
            cmd = [sys.executable, str(WORKER), str(spec_path), str(rank)]
        else:
            cmd = [sys.executable] + argv
        procs.append((subprocess.Popen(
            cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="1",
                     **((env or {}) | {"RANK": str(rank)}))), log))
    codes = []
    for proc, log in procs:
        try:
            codes.append(proc.wait(timeout=TIMEOUT))
        finally:
            if proc.poll() is None:
                proc.kill()
            log.close()
    logs = "\n".join((out / f"rank{r}.log").read_text()[-3000:]
                     for r in range(world))
    assert codes == [0] * world, logs


@pytest.fixture(scope="module")
def runs(reference):
    """The worker at each mesh, once."""
    done = {}

    def run(n_data, n_fsdp, gather=True):
        name = f"{n_data}x{n_fsdp}{'' if gather else '-no-gather'}"
        if name not in done:
            out = reference["tmp"] / name
            spec = dict(store=str(out / "store"), world=n_data * n_fsdp,
                        n_data=n_data, n_fsdp=n_fsdp, gather=gather,
                        cfg=reference["cfg"], restore=str(reference["w0"]),
                        batch=str(reference["batch"]), out=str(out),
                        validate=gather and n_fsdp == 1)
            _launch(spec, n_data * n_fsdp, out)
            done[name] = out
        return done[name]

    return run


def _grads(mu):
    return {n: m / 0.1 for n, m in mu.items()}  # mu_1 = 0.1 g (clipped)


def _check_against_one_process(after: dict, reference) -> None:
    one = reference["one"]
    want = one.state.state_dict()
    got = after["state"]
    np.testing.assert_allclose(after["metrics"]["loss"],
                               reference["metrics"]["loss"], rtol=PORT_RTOL)
    for group in ("mu", "nu"):
        top = max(float(w.abs().max()) for w in want[group].values())
        for name, w in want[group].items():
            scale = max(float(w.abs().max()), NOISE_FLOOR * top)
            np.testing.assert_allclose(got[group][name], w, rtol=0,
                                       atol=PORT_RTOL * scale,
                                       err_msg=f"{group} {name}")
    grads = _grads(want["mu"])
    for group in ("params", "ema"):
        for name, w in want[group].items():
            g = grads[name].abs()
            firm = g >= max(FIRM * float(g.max()), 1e-6)
            np.testing.assert_allclose(
                got[group][name][firm], w[firm], rtol=0,
                atol=PORT_RTOL * float(w.abs().max()),
                err_msg=f"{group} {name}")
    np.testing.assert_allclose(after["loss_history"],
                               one.sampler_state.loss_history, rtol=PORT_RTOL)
    assert torch.equal(after["loss_counts"], one.sampler_state.loss_counts)
    assert got["step"] == want["step"] == 1 and got["count"] == 1


def _check_against_jax(after: dict, reference) -> None:
    model = reference["one"].model
    jstate = reference["jstate"]
    adam = jstate.opt_state[-1][0]
    for k, v in reference["jmetrics"].items():
        np.testing.assert_allclose(after["metrics"][k], v, rtol=JAX_RTOL,
                                   err_msg=k)
    got_g = _grads(after["state"]["mu"])
    want_g = _grads(flax_to_state_dict(jax.device_get(adam.mu), model))
    top = max(float(g.abs().max()) for g in want_g.values())
    for name, w in want_g.items():
        scale = max(float(w.abs().max()), NOISE_FLOOR * top)
        np.testing.assert_allclose(got_g[name], w, rtol=0,
                                   atol=JAX_GRAD_TOL * scale, err_msg=name)
    for group, tree in (("params", jstate.params),
                        ("ema", jstate.ema_params)):
        want = flax_to_state_dict(jax.device_get(tree), model)
        for name, w in want.items():
            g = want_g[name].abs()
            firm = g >= max(FIRM * float(g.max()), 1e-6)
            np.testing.assert_allclose(
                after["state"][group][name][firm], w[firm], rtol=0,
                atol=JAX_PARAM_ATOL, err_msg=f"{group} {name}")
    np.testing.assert_allclose(after["loss_history"],
                               np.asarray(reference["jsampler"].loss_history),
                               rtol=JAX_RTOL)


@pytest.mark.parametrize("mesh", ["2x1", "2x2", "2x1-no-gather"])
def test_train_step_equals_one_process_and_jax_mesh(runs, reference, mesh):
    n_data, n_fsdp = int(mesh[0]), int(mesh[2])
    gather = not mesh.endswith("no-gather")
    out = runs(n_data, n_fsdp, gather)
    after = torch.load(out / "after.pt", weights_only=True)
    if not gather:
        # each rank's ratio over its own rows is another loss: the gradient
        # of the disentangle terms, and the moments with it, move
        with pytest.raises(AssertionError):
            _check_against_one_process(after, reference)
        return
    _check_against_one_process(after, reference)
    _check_against_jax(after, reference)
    # 4 ranks restored one process's checkpoint bit for bit
    restored = torch.load(out / "restored.pt", weights_only=True)
    for group, tensors in reference["w0_state"].items():
        if isinstance(tensors, dict):
            for name, t in tensors.items():
                assert torch.equal(restored[group][name], t), (group, name)
        else:
            assert restored[group] == tensors


def _jax_rank_bytes(reference) -> list:
    """Bytes of params, EMA and both moments each device of the (2, 2) mesh
    holds, in rank order (rank = d * 2 + f)."""
    state = reference["jstate0"]
    adam = state.opt_state[-1][0]
    per = {}
    for tree in (state.params, state.ema_params, adam.mu, adam.nu):
        for leaf in jax.tree.leaves(tree):
            for shard in leaf.addressable_shards:
                per[shard.device] = per.get(shard.device, 0) + shard.data.nbytes
    devices = np.asarray(reference["mesh"].devices).reshape(-1)
    return [per[d] for d in devices]


def test_state_sharding_follows_the_jax_plan(runs, reference):
    model = reference["one"].model
    plan = pmesh.plan_sharding(model, 2, MIN_SIZE)
    assert any(ax is not None for ax in plan.values())
    assert any(ax is None for ax in plan.values())
    split = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(
            reference["shardings"].params["params"],
            is_leaf=lambda s: isinstance(s, NamedSharding))[0]:
        *mods, leaf = [k.key for k in path]
        name = ".".join(mods + ["weight" if leaf in ("kernel", "scale")
                                else leaf])
        spec = tuple(sharding.spec)
        split[name] = spec.index("fsdp") if "fsdp" in spec else None
    assert set(split) == set(plan)
    modules = dict(model.named_modules())
    for name, ax in plan.items():
        mod_name, leaf = name.rsplit(".", 1)
        p = dict(model.named_parameters())[name]
        axes = pmesh.flax_axes(modules[mod_name], leaf, p.ndim)
        assert (None if ax is None else axes[ax]) == split[name], name
    assert pmesh.state_sharding(pmesh.Mesh(2, 2), model, MIN_SIZE) == {
        group: plan for group in ("params", "ema", "mu", "nu")}
    local = pmesh.local_mesh()
    assert local.shape == {"data": 1, "fsdp": 1} and not local.distributed
    rows = pmesh.shard_batch(local, {"image": np.ones((2, 4, 4, 3), np.float32),
                                     "case": ["a", "b"]}, "cpu")
    assert set(rows) == {"image"} and rows["image"].shape == (2, 4, 4, 3)
    params = dict(model.named_parameters())
    jparams = reference["jstate0"].params
    want = JMesh.sharded_byte_fraction(
        jparams, JMesh.param_sharding(reference["mesh"], jparams, MIN_SIZE))
    assert 0 < want < 1
    assert pmesh.sharded_byte_fraction(params, plan) == pytest.approx(
        want, rel=1e-12)
    out = runs(2, 2)
    got = [json.loads((out / f"bytes_{r}.json").read_text()) for r in range(4)]
    assert got == _jax_rank_bytes(reference)
    one = reference["one"].state.local_nbytes()
    assert all(b < one for b in got)


def test_checkpoint_of_four_ranks_restores_in_one_process(runs, reference,
                                                          tmp_path):
    out = runs(2, 2)
    after = torch.load(out / "after.pt", weights_only=True)["state"]
    one = Trainer(reference["cfg"], tmp_path / "one", device="cpu")
    ckpt = CheckpointManager(out / "run" / "checkpoint")
    assert ckpt.all_steps() == [1]
    one.state, one.sampler_state = ckpt.restore(one.state, one.sampler_state)
    got = one.state.state_dict()
    for group, tensors in after.items():
        if isinstance(tensors, dict):
            for name, t in tensors.items():
                assert torch.equal(got[group][name], t), (group, name)
        else:
            assert got[group] == tensors


def test_validate_under_two_ranks_gives_one_process_metrics(runs, reference):
    out = runs(2, 1)
    got = json.loads((out / "val.json").read_text())
    for k, v in reference["val"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("index", [0, 1])
def test_batch_loader_rows_per_rank_are_jax(store, index):
    common = dict(root=store / "data", split="images_tr_16", keys=KEYS)
    want = JBatchLoader(JSliceDataset(**common), 4, seed=3, process_count=2,
                        process_index=index)
    got = BatchLoader(SliceDataset(**common), 4, seed=3, process_count=2,
                      process_index=index)
    assert got.local_batch_size == 2 and len(got) == len(want)
    for a, b in zip(got.epoch(1), want.epoch(1)):
        for k in ("image", "target", "valid"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["case"] == b["case"] and a["slice"] == b["slice"]
    # without a process group: one process
    default = BatchLoader(SliceDataset(**common), 4)
    assert (default.process_count, default.process_index) == (1, 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_train_under_two_gloo_ranks_trains_saves_and_resumes(
        store, tmp_path):
    import yaml

    cfg = _cfg(store)
    cfg.update(result_path=str(tmp_path / "results"), Task_name="synth",
               schedule_sampler="uniform", train_batch_size=2)
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump(cfg))
    argv = ["-m", "dsdiff_torch.cli.train", "--config_file", str(path),
            "--device", "cpu"]
    workdir = tmp_path / "results" / "synth_r1_ds_diff_gaussian_fold2-0"
    for run, more in enumerate((["--max_steps", "1"], ["--max_steps", "2"])):
        env = dict(WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()))
        _launch({}, 2, tmp_path / f"launch{run}", env=env, argv=argv + more)
        assert CheckpointManager(workdir / "checkpoint").latest_step() == run + 1
    journal = (workdir / "log_txt.txt").read_text()
    assert "resumed from step 1" in journal
    assert journal.count("training finished") == 2  # rank 0 alone writes
    rows = [json.loads(r) for r in (workdir / "logs" / "progress.jsonl")
            .read_text().splitlines()]
    assert len(rows) == 2 and all("val_ssim" in r for r in rows)
