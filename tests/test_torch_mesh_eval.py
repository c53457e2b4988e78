"""Palette training and sharded validation / prediction under a mesh
(``Trainer(..., mesh=...)``) on two gloo ranks against one process of the
port, on the CPU.

The ranks are subprocesses of ``tests/torch_dist_worker.py`` (mode
``eval``, no JAX) over a ``file://`` store, each restoring one checkpoint
of seeded random weights that one process of the port wrote. On a
synthetic npy store at 16² (5 cases of 7 slices: 4 train cases, of which
``fold_K`` 2 gives 2 for validation, and 1 test case of 7 slices, whose
last batch the loader pads with invalid rows):

- palette (the tiny UNet, DDIM-3 with eta 1, so every step draws noise):
  ``validate`` over two batches, each rank sampling two rows of each, then
  one train step at a global batch of 4 whose t and noise both sides draw
  from a generator seeded alike: the loss within 1e-5 relative, the AdamW
  moments, parameters and EMA within ``test_torch_parallel.py``'s
  tolerances for the flagship (1e-5 of the leaf's scale; parameters on
  the elements whose gradient is firm);
- the flagship (the ``TINY`` DSUNet, DDIM-3): ``validate`` and ``predict``
  of the test split with the metric report, on a (data 2, fsdp 1) mesh at
  ``val_batch_size`` 4 (each rank samples 2 rows of every batch, the
  padding included) and on a (data 1, fsdp 2) mesh at ``val_batch_size``
  3, whose batches the two ranks do not divide: each runs whole on every
  rank.

Metrics, metric rows and the written volumes agree with one process within
1e-5, and every rank reports the same metrics. One process of the port
matches the JAX package's palette step and sampler given its draws:
``test_torch_families.py`` holds that.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dsdiff_torch.data import synthetic
from dsdiff_torch.data.nifti import Nifti, read_nifti, write_nifti
from dsdiff_torch.train.checkpoints import CheckpointManager
from dsdiff_torch.train.trainer import Trainer
from dsdiff_torch.utils.flax_bridge import random_params
from torch_parity_utils import one_thread, tiny_cfg  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
KEYS = ["A", "B", "C", "GT"]
WORLD = 2
B = 4  # the global train batch
VAL_BATCHES = 2
TOL = 1e-5  # ranks against one process
NOISE_FLOOR = 1e-2
FIRM = 1e-2
TIMEOUT = 240
TRAIN_SEED = 17

UNET = dict(model_channels=32, num_res_blocks=1, attention_resolutions=[2],
            channel_mult=[1, 2], num_heads=2, use_scale_shift_norm=True)
PALETTE = dict(net_mode="palette", learn_sigma=False,
               disentangle_distance=None, unet_config={"params": UNET},
               sampler_setting={"sampler": "ddim", "sample_steps": 3,
                                "ddim_eta": 1.0},
               palette={"train_schedule": {"n_timestep": 2000,
                                           "linear_start": 1e-6,
                                           "linear_end": 0.01},
                        "test_schedule": {"n_timestep": 30,
                                          "linear_start": 1e-4,
                                          "linear_end": 0.09}})


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The npy store and the test case's target volume as NIfTI."""
    root = tmp_path_factory.mktemp("mesh_eval")
    data = synthetic.make_structured_dataset(
        root / "data", n_cases=5, n_slices=7, hw=16, seed=0, store="npy")
    gt = root / "gt"
    for case_dir in sorted((data / "images_ts_16").iterdir()):
        stack = np.load(case_dir / "GT.npy")  # [S, H, W]
        (gt / case_dir.name).mkdir(parents=True)
        write_nifti(gt / case_dir.name / "GT.nii.gz",
                    Nifti(np.ascontiguousarray(stack.transpose(1, 2, 0))))
    return root


def _cfg(store, palette: bool, val_batch: int = 4) -> dict:
    cfg = tiny_cfg(3)
    cfg.update(h5_2d_img_dir=str(store / "data"), data_store="npy",
               image_size=16, train_keys=KEYS, train_batch_size=B,
               val_batch_size=val_batch, fold_K=2, fold_idx=0,
               log_images=False)
    if palette:
        cfg.update(PALETTE)
    return cfg


def _launch(spec: dict, out: Path) -> None:
    """Run the WORLD ranks to their end; each rank's output goes to
    ``out/rank<r>.log``."""
    out.mkdir(parents=True, exist_ok=True)
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    procs = []
    for rank in range(WORLD):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), str(spec_path), str(rank)],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="1")), log))
    codes = []
    for proc, log in procs:
        try:
            codes.append(proc.wait(timeout=TIMEOUT))
        finally:
            if proc.poll() is None:
                proc.kill()
            log.close()
    logs = "\n".join((out / f"rank{r}.log").read_text()[-3000:]
                     for r in range(WORLD))
    assert codes == [0] * WORLD, logs


def _one_and_ranks(store, tmp: Path, palette: bool, n_data: int = WORLD,
                   val_batch: int = 4) -> dict:
    """One process from seeded weights (its checkpoint W0), then the ranks
    of a (n_data, WORLD / n_data) mesh from W0, doing the same."""
    cfg = _cfg(store, palette, val_batch)
    one = Trainer(cfg, tmp / "one", device="cpu")
    random_params(one.model, 3)
    one.reset_state()
    w0 = CheckpointManager(tmp / "w0")
    w0.save(0, one.state, one.sampler_state)
    spec = dict(mode="eval", store=str(tmp / "store"), world=WORLD,
                n_data=n_data, n_fsdp=WORLD // n_data, cfg=cfg, restore=str(w0.directory),
                out=str(tmp / "ranks"), val_batches=VAL_BATCHES,
                gt_root=str(store / "gt"), gt_name="GT.nii.gz")
    ref = {"val": one.validate(max_batches=VAL_BATCHES)}
    if palette:
        rng = np.random.default_rng(21)
        batch = {"target": rng.uniform(-1, 1, (B, 16, 16, 1)),
                 "image": rng.standard_normal((B, 16, 16, 3))}
        batch = {k: v.astype(np.float32) for k, v in batch.items()}
        np.savez(tmp / "batch.npz", **batch)
        metrics = one.train_step(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.Generator().manual_seed(TRAIN_SEED))
        ref.update(metrics={k: float(v) for k, v in metrics.items()},
                   state=one.state.state_dict())
        spec.update(batch=str(tmp / "batch.npz"), train_seed=TRAIN_SEED)
    else:
        pred_dir, rows = one.predict(tmp / "one_pred",
                                     template_root=store / "gt",
                                     gt_root=store / "gt",
                                     gt_name="GT.nii.gz")
        ref.update(pred_dir=pred_dir, rows=rows)
        spec.update(predict=True)
    _launch(spec, tmp / "ranks")
    return ref


@pytest.fixture(scope="module")
def palette_run(store, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("palette")
    return _one_and_ranks(store, tmp, palette=True), tmp / "ranks"


# (data, fsdp) mesh -> (val_batch_size, rows each rank samples a call:
# two validation batches, then the test split's)
FLAGSHIP_MESHES = {(2, 1): (4, [2, 2] + [2, 2]),
                   (1, 2): (3, [3, 3] + [3, 3, 3])}


@pytest.fixture(scope="module", params=sorted(FLAGSHIP_MESHES))
def flagship_run(store, tmp_path_factory, request):
    n_data, _ = request.param
    val_batch, rows = FLAGSHIP_MESHES[request.param]
    tmp = tmp_path_factory.mktemp(f"flagship_{n_data}")
    ref = _one_and_ranks(store, tmp, palette=False, n_data=n_data,
                         val_batch=val_batch)
    return ref, tmp / "ranks", rows


def _check_val(ref: dict, out: Path) -> None:
    for rank in range(WORLD):
        got = json.loads((out / f"val_{rank}.json").read_text())
        assert sorted(got) == sorted(ref["val"])
        for k, v in ref["val"].items():
            np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                       err_msg=f"rank {rank} {k}")


def test_palette_validate_is_sharded_and_matches_one_process(palette_run):
    ref, out = palette_run
    _check_val(ref, out)
    for rank in range(WORLD):  # every val batch of 4: two rows a rank
        assert json.loads((out / f"sampled_{rank}.json").read_text()) == [
            2] * VAL_BATCHES


def test_palette_train_step_on_two_ranks_matches_one_process(palette_run):
    """Global t and noise drawn from one seeded generator on both sides;
    the tolerances of ``test_torch_parallel.py``'s flagship step."""
    ref, out = palette_run
    after = torch.load(out / "after.pt")
    assert sorted(after["metrics"]) == sorted(ref["metrics"]) == [
        "grad_norm", "loss", "loss_simple"]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(after["metrics"][k], v, rtol=TOL,
                                   err_msg=k)
    want, got = ref["state"], after["state"]
    for group in ("mu", "nu"):
        top = max(float(w.abs().max()) for w in want[group].values())
        for name, w in want[group].items():
            scale = max(float(w.abs().max()), NOISE_FLOOR * top)
            np.testing.assert_allclose(got[group][name], w, rtol=0,
                                       atol=TOL * scale,
                                       err_msg=f"{group} {name}")
    for group in ("params", "ema"):
        for name, w in want[group].items():
            g = want["mu"][name].abs()  # mu_1 = 0.1 g
            firm = g >= max(FIRM * float(g.max()), 1e-7)
            np.testing.assert_allclose(
                got[group][name][firm], w[firm], rtol=0,
                atol=TOL * float(w.abs().max()), err_msg=f"{group} {name}")
    assert got["step"] == want["step"] == 1


def test_flagship_validate_and_predict_sharded_match_one_process(
        flagship_run):
    ref, out, rows_sampled = flagship_run
    _check_val(ref, out)
    for rank in range(WORLD):
        assert json.loads((out / f"sampled_{rank}.json").read_text()) == (
            rows_sampled)
    rows = json.loads((out / "rows.json").read_text())
    assert [r["case"] for r in rows] == [r["case"] for r in ref["rows"]]
    assert len(rows) == 1
    for got, want in zip(rows, ref["rows"]):
        for k, v in want.items():
            if k != "case":
                np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                           err_msg=k)
    want_files = sorted(p.name for p in Path(ref["pred_dir"]).glob("*.nii.gz"))
    got_files = sorted(p.name for p in (out / "pred").glob("*.nii.gz"))
    assert got_files == want_files and want_files
    for name in want_files:
        a = read_nifti(out / "pred" / name).data
        b = read_nifti(Path(ref["pred_dir"]) / name).data
        assert a.shape == b.shape == (16, 16, 7)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=name)
