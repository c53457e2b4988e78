"""The plain reference held against the port's modules on the CPU at a
tiny size: with the program in f32 (``bf16: false``) the comparison the
benchmark makes must read rounding alone, for each cell's path and for a
model kind that has no cell, added by files alone; and the FLOPs stored in
each configuration file are the reference's count."""
import copy

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import check, data, program, spec
from benchmark.harness.seeds import sub_seed
from benchmark.reference import flops, models
from tiny import tiny_cell, tiny_config, tiny_traffic

SEED = 2**31 + 11
CELLS = {w["name"]: spec.load_json(spec.traffic_path(w["traffic"]))["kind"]
         for w in spec.benchmark()["workloads"]}
FIXTURES = spec.BENCH / "tests" / "fixture_denoisers"


def _serve_numbers(cfg: dict, traffic: dict, seed: int) -> dict:
    """One request of the port on the CPU, followed step by step by the
    reference (``check.serve_numbers``) and against the reference's own
    chain (``free_gap_*``)."""
    torch.manual_seed(0)
    wseed = sub_seed(seed, "weights")
    trainer = program.build_trainer(cfg, wseed, "cpu")
    pool = data.ServePool(cfg, traffic, seed, "cpu")
    rec = program.Recorder(trainer.sample_model)
    rec.active = []
    cond, x_T = pool.request(0)
    out = trainer.sample_fn(cond, None, x_T)
    records = [(0, rec.active, out)]
    nums = check.serve_numbers(cfg, traffic, wseed, "cpu", pool, records)
    nums.update(calibrate.free_running_gaps(cfg, traffic, wseed, "cpu", pool,
                                            records))
    return nums


def _train_numbers(cfg: dict, traffic: dict, seed: int) -> dict:
    """The port's first three train steps on the CPU against the
    reference's (``check.train_numbers``, and the numbers calibration
    reads beside them)."""
    torch.manual_seed(0)
    wseed = sub_seed(seed, "weights")
    trainer = program.build_trainer(cfg, wseed, "cpu")
    feed = data.TrainFeed(cfg, traffic, seed, "cpu")
    fed = [feed.next() for _ in range(3)]
    prog = check.TrainReadings(0.9)
    for k, (batch, t, noise) in enumerate(fed):
        m = trainer.train_step(batch, None, t=t, noise=noise)
        prog.after_step(k, m, lambda: program.state_snapshot(trainer), wseed,
                        "cpu")
    ref = check.reference_train_readings(cfg, wseed, "cpu", fed)
    nums = check.train_numbers(prog, ref)
    nums.update(calibrate.read_only_train(prog, ref))
    return nums


def _serve_at_rounding(nums):
    assert nums["calls_off"] == 0 and nums["start_gap"] == 0
    assert nums["cond_gap"] == 0
    assert nums["step_gap_max"] < 1e-4
    assert nums["free_gap_max"] < 1e-3


def _train_at_rounding(nums):
    assert nums["loss_gap"] < 1e-5 and nums["loss_gap_step1"] < 1e-5
    assert nums["grad_gap"] < 1e-4 and nums["grad_diff"] < 1e-4
    assert nums["half_lean"] < 1e-3
    assert nums["change_gap"] < 1e-3
    assert nums["ema_gap"] < 1e-3


@pytest.mark.parametrize("name", [n for n, k in CELLS.items() if k == "serve"])
def test_serve_steps_match_the_port_in_f32(name):
    cell = tiny_cell(name, bf16=False)
    _serve_at_rounding(_serve_numbers(cell.config, cell.traffic, SEED))


@pytest.mark.parametrize("name", [n for n, k in CELLS.items() if k == "train"])
def test_train_steps_match_the_port_in_f32(name):
    cell = tiny_cell(name, bf16=False)
    _train_at_rounding(_train_numbers(cell.config, cell.traffic, SEED))


def test_an_unknown_model_raises_naming_its_file():
    cfg = dict(spec.load_cell("flagship-serve-b8").config, model="no_such_kind")
    with pytest.raises(ValueError, match=r"denoisers/no_such_kind\.py"):
        models.build(cfg)


def _new_kind(monkeypatch):
    """A configuration of a kind the benchmark has no reference for, the
    port's plain ``ddpm`` UNet, its reference found in a directory of its
    own: the flagship's trainer block with ``net_mode: ddpm`` (the LDM
    'linear' schedule), no disentangle losses and no learned sigma."""
    monkeypatch.setattr(models, "DENOISERS", FIXTURES)
    cfg = copy.deepcopy(spec.load_cell("flagship-train-b32").config)
    cfg["model"] = "ddpm"
    cfg["trainer"].update(net_mode="ddpm", disentangle_distance=None,
                          learn_sigma=False)
    return cfg


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_a_new_kind_is_new_files_alone(kind, monkeypatch):
    cfg = tiny_config(_new_kind(monkeypatch), bf16=False)
    assert flops.forward_flops_per_sample(cfg) > 0
    cell = next(n for n, k in CELLS.items() if k == kind)
    traffic = tiny_traffic(spec.load_cell(cell).traffic)
    if kind == "serve":
        _serve_at_rounding(_serve_numbers(cfg, traffic, SEED))
    else:
        _train_at_rounding(_train_numbers(cfg, traffic, SEED))


@pytest.mark.parametrize("entry", spec.benchmark()["configs"],
                         ids=lambda e: e["name"])
def test_stored_flops_are_the_reference_count(entry):
    cfg = spec.load_json(spec.ROOT / entry["file"])
    assert cfg["forward_flops_per_sample"] == flops.forward_flops_per_sample(cfg)


def test_fp8_control_rounds_operands():
    from benchmark.reference import layers

    x = torch.linspace(-3, 3, 1001)
    layers.set_precision("fp8")
    try:
        q = layers.rounded(x)
    finally:
        layers.set_precision("f32")
    # e4m3 keeps 3 mantissa bits: a rounding moves a value by 2**-4 of it
    # at most (above the scaled subnormals)
    err = (q - x).abs()
    assert float(err.max()) > 0
    assert bool((err <= x.abs() * 2**-4 + 3 / 448 * 2**-6).all())
    assert torch.equal(layers.rounded(x), x)
