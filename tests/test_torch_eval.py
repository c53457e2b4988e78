"""The port's evaluation against the JAX package's, on the CPU: the host
volume metrics (the same numpy code: 1e-12 relative), ``ms_ssim`` in torch
against the jitted JAX one (f32, 2e-5 absolute: the Gaussian filter sums in
another order), ``evaluate_volume``, and ``VolumeAssembler`` /
``evaluate_predictions`` over the same slices: the same files (NIfTI bodies
byte for byte) and the same CSV rows. MS-SSIM in a row is taken on the
12-bit rescaled volume (values near 2048, data range 4095), where the f32
moments E[x²] - E[x]² cancel about 4e6 to the variance: 1e-4 relative
there, the other columns 1e-9."""
import csv
import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.eval import assemble as JA
from dsdiff_tpu.eval import metrics as JM
from dsdiff_torch.eval import assemble as PA
from dsdiff_torch.eval import metrics as PM

MS_TOL = 2e-5
ROW_TOL = {"ms_ssim": 1e-4}  # else 1e-9


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    t = np.clip(rng.standard_normal(shape) * 0.4, -1, 1).astype(np.float32)
    p = np.clip(t + rng.standard_normal(shape) * 0.1, -1, 1).astype(np.float32)
    return t, p


@pytest.mark.parametrize("name", ["nrmse", "smape", "logac", "medsymac",
                                  "psnr", "mae", "nmi", "cc"])
def test_host_metrics_match(name):
    t, p = _pair(0, (20, 18, 5))
    mask = np.zeros(t.shape, bool)
    mask[3:15, 2:16, 1:4] = True
    for m in (None, mask):
        np.testing.assert_allclose(getattr(PM, name)(t, p, m),
                                   getattr(JM, name)(t, p, m), rtol=1e-12)


def test_dice_and_scale12bit_match():
    rng = np.random.default_rng(1)
    a, b = rng.integers(0, 3, (8, 8, 4)), rng.integers(0, 3, (8, 8, 4))
    for label in (1, 2, 7):
        assert PM.dice(a, b, label) == JM.dice(a, b, label)
    x = rng.standard_normal((9, 9))
    np.testing.assert_array_equal(PM.scale12bit(x), JM.scale12bit(x))


@pytest.mark.parametrize("shape, levels", [((3, 64, 64), 3), ((2, 176, 180), 5)])
def test_ms_ssim_matches(shape, levels):
    t, p = _pair(2, shape)
    t[0, :20] = 0.9  # a flat region with |mean| near 1
    p[0, :20] = 0.9
    got = PM.ms_ssim(torch.from_numpy(t), torch.from_numpy(p), 2.0,
                     levels=levels)
    want = JM.ms_ssim(jnp.asarray(t), jnp.asarray(p), 2.0, levels=levels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MS_TOL)
    assert float(got.max()) <= 1.0


def test_evaluate_volume_and_cw_ssim_match():
    t, p = _pair(3, (48, 40, 3))
    mask = np.zeros(t.shape, bool)
    mask[5:40, 4:36] = True
    for m in (None, mask):
        got = PM.evaluate_volume(t, p, m)
        want = JM.evaluate_volume(t, p, m)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k],
                                       rtol=ROW_TOL.get(k, 1e-9), err_msg=k)


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_assembly_and_metric_report_match(tmp_path):
    from dsdiff_tpu.data.nifti import Nifti, write_nifti

    rng = np.random.default_rng(4)
    gt_root = tmp_path / "gt"
    # two cases, 4 slices of 32² padded from 30x28 templates
    vols = {}
    for case in ("case000", "case001"):
        vols[case] = rng.uniform(-1, 1, (30, 28, 4)).astype(np.float32)
        (gt_root / case).mkdir(parents=True)
        write_nifti(gt_root / case / "GT.nii.gz",
                    Nifti(vols[case], np.diag([0.7, 0.7, 3.0, 1.0])))
    preds = rng.uniform(-1, 1, (8, 32, 32, 1)).astype(np.float32)
    preds[7] = np.nan  # a padded row, never assembled
    cases = ["case000"] * 4 + ["case001"] * 3
    slices = [0, 1, 2, 3, 0, 1, 2]
    valid = np.array([True, True, False])  # the second batch's padded tail
    out = {}
    for name, A in (("jax", JA), ("port", PA)):
        asm = A.VolumeAssembler(tmp_path / name, task_id="r1")
        asm.add_batch(cases[:5], slices[:5], preds[:5])
        asm.add_batch(cases[5:] + ["pad"], slices[5:] + [0], preds[5:], valid)
        assert asm.cases() == ["case000", "case001"]
        for case in asm.cases():
            asm.write_case(case, gt_root / case / "GT.nii.gz")
        rows = A.evaluate_predictions(tmp_path / name, gt_root, "GT.nii.gz",
                                      report_path=tmp_path / name / "metrics.csv")
        A.write_metric_report(rows, tmp_path / name / "metrics.xlsx")
        out[name] = rows
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "metrics.csv", "metrics.xlsx", "r1_case000_pred.nii.gz",
        "r1_case001_pred.nii.gz"]
    for f in files[2:]:  # gzip headers carry the file's time: compare bodies
        assert gzip.decompress((tmp_path / "jax" / f).read_bytes()) == \
            gzip.decompress((tmp_path / "port" / f).read_bytes())
    want, got = (_read_csv(tmp_path / n / "metrics.csv") for n in ("jax", "port"))
    assert [r["case"] for r in got] == [r["case"] for r in want] == [
        "case000", "case001", "mean"]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k != "case":
                np.testing.assert_allclose(float(g[k]), float(w[k]),
                                           rtol=ROW_TOL.get(k, 1e-9), err_msg=k)
