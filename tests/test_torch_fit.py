"""The slice as a whole on the CPU: the JAX package's ``Trainer.fit`` and
the port's, from the same Flax weights (the ``TINY`` DSUNet, f32) on the same
synthetic H5 store (16² slices padded to 32², batch 2, two epochs of two
steps, shuffle and augmentation on), the port's train step given JAX's t
and noise (recomputed from the JAX ``fit``'s step key): per-step losses and
metrics agree to 1e-4 relative, and ``fit`` / ``validate`` write the same
files (logs, the journal, checkpoints of the same steps; the image dumps
are held in ``test_torch_cli.py``). ``predict`` on both sides with the
sampler replaced by one function of the condition writes the same volumes
and metric rows: that function (tanh of the mean) rounds differently in
XLA and PyTorch by an f32 ulp, so the rows agree to 1e-5 relative, MS-SSIM
(12-bit scale) to 1e-4."""
import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.data import synthetic as JS
from dsdiff_tpu.data.nifti import Nifti, write_nifti
from dsdiff_tpu.data import h5store as JH
from dsdiff_tpu.parallel import mesh as pmesh
from dsdiff_tpu.train import Config as JConfig
from dsdiff_tpu.train import Trainer as JTrainer
from dsdiff_tpu.train import state as JState
from dsdiff_torch.train.trainer import Trainer
from torch_parity_utils import one_thread, random_flax_params, tiny_cfg

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-4
ROW_TOL = {"ms_ssim": 1e-4}  # else 1e-5
KEYS = ["A", "B", "C", "GT"]
# logged every step by both, but host timing: not compared
TIMING = ("steps_per_sec_per_chip", "_wall_s")


def _jax_draws(rng, step, shape):
    """The t and noise that ``make_train_step`` draws at ``step``."""
    key = jax.random.fold_in(rng, step)
    t_rng, n_rng, _, _ = jax.random.split(key, 4)
    t = jax.random.randint(t_rng, (shape[0],), 0, 1000)
    noise = jax.random.normal(n_rng, shape, jnp.float32)
    return torch.from_numpy(np.array(t, np.int64)), torch.from_numpy(np.array(noise))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    JS.make_structured_dataset(root / "data", n_cases=5, n_slices=2, hw=16,
                               seed=0)
    gt_root = root / "gt"
    for case in JH.list_cases(root / "data" / "images_ts_16"):
        paths = JH.case_slices(root / "data" / "images_ts_16" / case)
        vol = np.stack([JH.read_slice(p, ["GT"])["GT"] for p in paths], -1)
        (gt_root / case).mkdir(parents=True)
        write_nifti(gt_root / case / "GT.nii.gz", Nifti(vol.astype(np.float32)))
    return root


def _cfg(store):
    cfg = tiny_cfg()
    cfg.update(h5_2d_img_dir=str(store / "data"), image_size=16,
               train_keys=KEYS, train_batch_size=2, val_batch_size=2,
               fold_K=2, fold_idx=0, limit_val_batches=1, log_images=False,
               augmentation_prob=0.5)
    return cfg


def _rows(workdir):
    return [json.loads(line) for line in
            (workdir / "logs" / "progress.jsonl").read_text().splitlines()]


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file() and "checkpoint" not in p.parts)


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def runs(store, tmp_path_factory):
    cfg = _cfg(store)
    tmp = tmp_path_factory.mktemp("runs")
    jt = JTrainer(JConfig.wrap(cfg), tmp / "jax", mesh=pmesh.local_mesh())
    params = random_flax_params(jt.state.params["params"], 5)
    jt.state = JState.TrainState.create(jt.model.apply, {"params": params},
                                        jt.state.tx, ema_decay=0.9999)
    step_rng = jax.random.split(jt.rng)[0]  # the key fit splits off first
    assert jt.fit(num_epochs=2, log_every=1, val_every_epochs=1) == 4

    pt = Trainer(cfg, tmp / "port", device="cpu")
    pt.load_flax_params({"params": params})
    step = pt.train_step

    def replay(batch, generator=None):
        t, noise = _jax_draws(step_rng, pt.state.step, batch["target"].shape)
        return step(batch, t=t, noise=noise)

    pt.train_step = replay
    assert pt.fit(num_epochs=2, log_every=1, val_every_epochs=1) == 4

    # predict through one function of the condition on both sides
    jt.sample_fn = lambda params, cond, rng: jnp.tanh(
        cond.mean(-1, keepdims=True))
    pt.sample_fn = lambda cond, generator=None: torch.tanh(
        cond.mean(-1, keepdim=True))
    preds = {}
    for name, tr in (("jax", jt), ("port", pt)):
        preds[name] = tr.predict(template_root=store / "gt",
                                 gt_root=store / "gt", gt_name="GT.nii.gz")
    jt.ckpt.close()
    return dict(jax=tmp / "jax", port=tmp / "port", preds=preds)


def test_fit_losses_match_jax_given_its_draws(runs):
    want = [r for r in _rows(runs["jax"]) if "step" in r]
    got = [r for r in _rows(runs["port"]) if "step" in r]
    assert [(r["step"], r["epoch"]) for r in got] == [
        (r["step"], r["epoch"]) for r in want] == [(1, 0), (2, 0), (3, 1),
                                                   (4, 1)]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k not in TIMING:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)


def test_validate_and_fit_write_the_same_files(runs):
    jv = [r for r in _rows(runs["jax"]) if "val_ssim" in r]
    pv = [r for r in _rows(runs["port"]) if "val_ssim" in r]
    assert len(jv) == len(pv) == 2 and all(set(a) == set(b)
                                           for a, b in zip(jv, pv))
    for r in pv:
        assert -1.0 <= r["val_ssim"] <= 1.0 and r["val_mae"] >= 0
    assert _files(runs["port"]) == _files(runs["jax"]) == [
        "log_txt.txt", "logs/progress.csv", "logs/progress.jsonl",
        "predictions/metrics.csv", "predictions/r1_case004_pred.nii.gz"]
    steps = {name: sorted(int(p.name) for p in (runs[name] / "checkpoint")
                          .iterdir() if p.name.isdigit())
             for name in ("jax", "port")}
    assert steps["port"] == steps["jax"] == [2, 4]
    saved = json.loads((runs["port"] / "checkpoint" / "4" / "metrics.json")
                       .read_text())
    assert saved == {"val_ssim": pv[-1]["val_ssim"], "val_mae": pv[-1]["val_mae"]}


def test_predict_writes_the_same_volumes_and_report(runs):
    (jdir, jrows), (pdir, prows) = runs["preds"]["jax"], runs["preds"]["port"]
    names = sorted(p.name for p in pdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir()) == [
        "metrics.csv", "r1_case004_pred.nii.gz"]
    assert len(prows) == len(jrows) == 1
    for g, w in zip(_read_csv(pdir / "metrics.csv"),
                    _read_csv(jdir / "metrics.csv")):
        assert list(g) == list(w)
        for k in w:
            if k != "case":
                np.testing.assert_allclose(float(g[k]), float(w[k]),
                                           rtol=ROW_TOL.get(k, 1e-5), err_msg=k)
            else:
                assert g[k] == w[k]
