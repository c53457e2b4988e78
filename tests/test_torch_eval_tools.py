"""The port's evaluation and measurement tools against the JAX package's, on
the CPU: ``core.process.prior_bpd`` (1e-6 relative), ``eval.suv`` (equal:
a numpy copy; ``read_dicom_tags`` on a minimal DICOM file the test writes),
``utils.profiling`` (``StepTimer``, ``profile_scope`` / ``scope_totals``,
``trace`` writing a chrome trace, ``compiled_flops`` equal to XLA's cost
analysis on a matmul and a VALID conv, where both count 2·M·N·K),
``utils.benchtime.chain_time`` and ``python -m dsdiff_torch.cli.evaluate``
against ``python -m dsdiff_tpu.cli.evaluate`` on a tiny NIfTI set (the same
rows and report).

Also the entry points' device default: each of them takes ``"cuda"`` when
no device is given and raises without a card, and runs with
``device="cpu"``, ``load_vgg16_lpips`` and ``parallel.dist.initialize``
included (the latter chose gloo on its own before).
"""
import ast
import csv
import json
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from dsdiff_torch.core import process as PProc
from dsdiff_torch.core import schedules as PSch
from dsdiff_torch.data.nifti import Nifti, write_nifti
from dsdiff_torch.eval import fid as PF
from dsdiff_torch.eval import perceptual as PP
from dsdiff_torch.eval import suv as PS
from dsdiff_torch.models import inception as PI
from dsdiff_torch.parallel import dist as pdist
from dsdiff_torch.utils import benchtime as PB
from dsdiff_torch.utils import profiling as PPr
from dsdiff_tpu.core import process as JProc
from dsdiff_tpu.core import schedules as JSch
from dsdiff_tpu.eval import suv as JS
from dsdiff_tpu.utils import profiling as JPr

ROOT = Path(__file__).resolve().parents[1]
ROW_TOL = {"ms_ssim": 1e-4}  # else 1e-9


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_prior_bpd_matches_jax(schedule):
    betas = JSch.make_beta_schedule(schedule, 1000)
    x0 = np.random.default_rng(0).uniform(-1, 1, (3, 8, 8, 2)).astype(
        np.float32)
    want = np.asarray(JProc.prior_bpd(JSch.DiffusionSchedule.create(betas),
                                      jnp.asarray(x0)))
    got = PProc.prior_bpd(PSch.DiffusionSchedule.create(betas, device="cpu"),
                          torch.from_numpy(x0))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------------- suv
def _element(group, elem, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b" "
    return struct.pack("<HH", group, elem) + vr + struct.pack(
        "<H", len(value)) + value


def write_minimal_dicom(path, tags: dict) -> None:
    """A DICOM part-10 file, explicit VR little endian, with the SUV tags:
    the radiopharmaceutical ones inside an undefined-length sequence of one
    item, and an unrelated US element before them."""
    item = b"".join([
        _element(0x0018, 0x1072, b"TM",
                 tags["RadiopharmaceuticalStartTime"].encode()),
        _element(0x0018, 0x1074, b"DS",
                 tags["RadionuclideTotalDose"].encode()),
        _element(0x0018, 0x1075, b"DS",
                 tags["RadionuclideHalfLife"].encode()),
    ])
    seq = (struct.pack("<HH", 0x0054, 0x0016) + b"SQ\x00\x00"
           + struct.pack("<I", 0xFFFFFFFF)
           + struct.pack("<HHI", 0xFFFE, 0xE000, len(item)) + item
           + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    body = b"".join([
        _element(0x0008, 0x0031, b"TM", tags["SeriesTime"].encode()),
        _element(0x0010, 0x1030, b"DS", tags["PatientWeight"].encode()),
        struct.pack("<HH", 0x0028, 0x0010) + b"US" + struct.pack("<HH", 2,
                                                                 256),
        _element(0x0028, 0x1052, b"DS", tags["RescaleIntercept"].encode()),
        _element(0x0028, 0x1053, b"DS", tags["RescaleSlope"].encode()),
        seq,
    ])
    Path(path).write_bytes(b"\x00" * 128 + b"DICM" + body)


TAGS = {"SeriesTime": "101500.25", "PatientWeight": "72.5",
        "RescaleIntercept": "0.5", "RescaleSlope": "1.25",
        "RadiopharmaceuticalStartTime": "093000",
        "RadionuclideTotalDose": "370000000", "RadionuclideHalfLife": "6586.2"}


def test_suv_matches_jax(tmp_path):
    path = tmp_path / "pet.dcm"
    write_minimal_dicom(path, TAGS)
    tags = PS.read_dicom_tags(path)
    assert tags == JS.read_dicom_tags(path) == TAGS
    with pytest.raises(ValueError, match="DICOM"):
        PS.read_dicom_tags(_not_dicom(tmp_path))
    rng = np.random.default_rng(1)
    pred = rng.uniform(-1.2, 1.2, (8, 8, 3))
    den, jden = (m.inverse_normalize(pred, 2.0, 900.0) for m in (PS, JS))
    np.testing.assert_array_equal(den, jden)
    assert den.min() >= 2.0 and den.max() <= 900.0
    np.testing.assert_array_equal(
        PS.inverse_normalize(pred, 2.0, 900.0, clip=False),
        JS.inverse_normalize(pred, 2.0, 900.0, clip=False))
    suv, jsuv = (m.suv_from_prediction(den, tags) for m in (PS, JS))
    np.testing.assert_array_equal(suv, jsuv)
    cases = {"c1": suv, "c0": 2 * suv}
    a = PS.suv_report(cases, tmp_path / "port" / "suv.csv")
    b = JS.suv_report(cases, tmp_path / "jax" / "suv.csv")
    assert a.read_text() == b.read_text()
    assert [r[0] for r in csv.reader(a.open())] == ["case", "c0", "c1"]


def _not_dicom(tmp_path):
    p = tmp_path / "plain.bin"
    p.write_bytes(b"\x00" * 200)
    return p


# -------------------------------------------------------------- profiling
def test_step_timer_and_scopes():
    timer = PPr.StepTimer(device="cpu")
    for _ in range(3):
        with PPr.profile_scope("unit_test_scope"):
            time.sleep(0.01)
        timer.tick()
    rate = timer.rate()
    assert 0 < rate < 100
    assert PPr.scope_totals()["unit_test_scope"] >= 0.03
    timer.reset()
    assert timer.rate() == 0.0
    assert PPr.steps_per_sec_per_chip(0.5, 2) == JPr.steps_per_sec_per_chip(
        0.5, 2) == 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with PPr.trace(tmp_path / "prof", device="cpu"):
        with PPr.profile_scope("traced_scope"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "traced_scope" in names


def test_compiled_flops_match_xla():
    """A matmul and a VALID conv, where XLA's cost analysis and torch's
    FLOP counter both count 2·M·N·K (a SAME conv's padding XLA leaves
    out)."""
    a, b = np.ones((64, 96), np.float32), np.ones((96, 80), np.float32)
    want = JPr.compiled_flops(lambda a, b: a @ b, jnp.asarray(a),
                              jnp.asarray(b))
    got = PPr.compiled_flops(lambda a, b: a @ b, torch.from_numpy(a),
                             torch.from_numpy(b))
    assert got == want == 2 * 64 * 96 * 80
    x, w = np.ones((2, 16, 16, 8), np.float32), np.ones((3, 3, 8, 12),
                                                        np.float32)
    want = JPr.compiled_flops(
        lambda x, w: jax.lax.conv_general_dilated(
            x, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO",
                                                      "NHWC")),
        jnp.asarray(x), jnp.asarray(w))
    got = PPr.compiled_flops(
        torch.nn.functional.conv2d,
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1))
    assert got == want == 2 * 2 * 14 * 14 * 12 * 8 * 9


def test_chain_time_and_fetch_scalar():
    x0 = torch.randn(32, 32, generator=torch.Generator().manual_seed(0))
    calls = []

    def fn(x):
        calls.append(1)
        return torch.tanh(x @ x)

    per_call = PB.chain_time(fn, x0, length=4, repeats=2)
    assert np.isfinite(per_call) and per_call > 0
    assert len(calls) == 4 * 3  # the warm-up chain and two timed
    assert PB.fetch_scalar({"a": [x0]}) == float(x0[0, 0])


# -------------------------------------------------------------- evaluate
def _nifti_set(root: Path, rng):
    pred_dir, gt_root = root / "pred", root / "gt"
    pred_dir.mkdir(parents=True)
    for case in ("case0", "case1"):
        gt = rng.uniform(0, 1, (32, 32, 4)).astype(np.float32)
        pred = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1)
        (gt_root / case).mkdir(parents=True)
        write_nifti(gt_root / case / "GT.nii.gz", Nifti(gt))
        write_nifti(pred_dir / f"task_{case}_pred.nii.gz",
                    Nifti(pred.astype(np.float32)))
    return pred_dir, gt_root


def _report_rows(path: Path) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def test_cli_evaluate_matches_jax(tmp_path):
    """The same cases and metrics, printed and in the report (with its mean
    row): MS-SSIM within 1e-4 relative (f32 convolutions in torch and in
    XLA), the other metrics (the same numpy code) within 1e-9, as
    ``test_torch_eval.py`` holds them."""
    pred_dir, gt_root = _nifti_set(tmp_path, np.random.default_rng(2))
    outs = {}
    for pkg in ("dsdiff_torch", "dsdiff_tpu"):
        report = tmp_path / f"{pkg}.csv"
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli.evaluate", "--pred_dir",
             str(pred_dir), "--gt_root", str(gt_root), "--gt_name",
             "GT.nii.gz", "--report", str(report)],
            cwd=ROOT, capture_output=True, text=True, timeout=240,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-3000:]
        printed = [ast.literal_eval(ln) for ln in proc.stdout.splitlines()
                   if ln.startswith("{")]
        assert proc.stdout.splitlines()[-1] == (
            f"report: {report} ({len(printed)} cases)")
        outs[pkg] = (printed, _report_rows(report))
    (got, got_csv), (want, want_csv) = outs["dsdiff_torch"], outs["dsdiff_tpu"]
    assert [r["case"] for r in got] == [r["case"] for r in want] == [
        "case0", "case1"]
    assert [r["case"] for r in got_csv] == [r["case"] for r in want_csv] == [
        "case0", "case1", "mean"]
    for g, w in zip(got + got_csv, want + want_csv):
        assert sorted(g) == sorted(w)
        for k in w:
            if k != "case":
                np.testing.assert_allclose(float(g[k]), float(w[k]),
                                           rtol=ROW_TOL.get(k, 1e-9),
                                           err_msg=k)


# ------------------------------------------------------- device defaults
def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _trace(dev, tmp):
    with PPr.trace(tmp, device=dev):
        pass
    return tmp / "trace.json"


ENTRY_POINTS = {
    "StepTimer": lambda dev, tmp: PPr.StepTimer(device=dev),
    "trace": _trace,
    "PerceptualLoss": lambda dev, tmp: PP.PerceptualLoss(device=dev),
    "fid": lambda dev, tmp: PF.fid(np.zeros((2, 16, 16, 1)),
                                   np.ones((2, 16, 16, 1)), device=dev),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(monkeypatch, tmp_path, name):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None, tmp_path / "none")
    assert ENTRY_POINTS[name]("cpu", tmp_path / "cpu") is not None


@pytest.mark.parametrize("kind", ["inception", "resnet50", "vgg16"])
def test_weight_loaders_default_to_cuda(monkeypatch, tmp_path, kind):
    """``load_inception`` and ``make_inception_extractor``,
    ``load_resnet50_perceptual`` and ``load_vgg16_lpips`` (which ran on the
    CPU unless asked otherwise before) raise without a card, before reading
    any file."""
    _no_card(monkeypatch)
    path = tmp_path / "absent.pth"
    loaders = {"inception": [PI.load_inception, PF.make_inception_extractor],
               "resnet50": [PP.load_resnet50_perceptual],
               "vgg16": [PP.load_vgg16_lpips]}[kind]
    for load in loaders:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(path)
        with pytest.raises(FileNotFoundError):
            load(path, device="cpu")


def test_dist_initialize_needs_a_card_or_cpu(monkeypatch, tmp_path):
    """Without a card and without ``device="cpu"`` / a backend,
    ``initialize`` raises instead of choosing gloo; with ``device="cpu"``
    it joins over gloo."""
    _no_card(monkeypatch)
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdist.initialize(store, 1, 0)
    assert not tdist.is_initialized()
    pdist.initialize(store, 1, 0, device="cpu")
    try:
        assert tdist.get_backend() == "gloo" and pdist.process_count() == 1
    finally:
        tdist.destroy_process_group()
