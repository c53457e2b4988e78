"""The plain reference held against the port's modules on the CPU at a
tiny size: with the program in f32 (``bf16: false``) the comparison the
benchmark makes must read rounding alone, for each cell's path; and the
FLOPs stored in each configuration file are the reference's count."""
import copy

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import check, data, program, spec
from benchmark.harness.seeds import sub_seed
from benchmark.reference import flops
from tiny import tiny_cell

SEED = 2**31 + 11


def f32_cell(name):
    cell = tiny_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["trainer"]["bf16"] = False
    return cell


@pytest.mark.parametrize("name", ["flagship-serve-b8", "discdiff-serve-b8"])
def test_serve_steps_match_the_port_in_f32(name):
    torch.manual_seed(0)
    cell = f32_cell(name)
    wseed = sub_seed(SEED, "weights")
    trainer = program.build_trainer(cell.config, wseed, "cpu")
    pool = data.ServePool(cell.config, cell.traffic, SEED, "cpu")
    rec = program.Recorder(trainer.sample_model)
    rec.active = []
    cond, x_T = pool.request(0)
    out = trainer.sample_fn(cond, None, x_T)
    records = [(0, rec.active, out)]
    nums = check.serve_numbers(cell.config, cell.traffic, wseed, "cpu", pool,
                               records)
    nums.update(calibrate.free_running_gaps(cell.config, cell.traffic, wseed,
                                            "cpu", pool, records))
    assert nums["calls_off"] == 0 and nums["start_gap"] == 0
    assert nums["cond_gap"] == 0
    assert nums["step_gap_max"] < 1e-4
    assert nums["free_gap_max"] < 1e-3


def test_train_steps_match_the_port_in_f32():
    torch.manual_seed(0)
    cell = f32_cell("flagship-train-b32")
    cfg = cell.config
    wseed = sub_seed(SEED, "weights")
    trainer = program.build_trainer(cfg, wseed, "cpu")
    feed = data.TrainFeed(cfg, cell.traffic, SEED, "cpu")
    fed = [feed.next() for _ in range(3)]
    prog = check.TrainReadings(0.9)
    for k, (batch, t, noise) in enumerate(fed):
        m = trainer.train_step(batch, None, t=t, noise=noise)
        prog.after_step(k, m, lambda: program.state_snapshot(trainer), wseed,
                        "cpu")
    ref = check.reference_train_readings(cfg, wseed, "cpu", fed)
    nums = check.train_numbers(prog, ref)
    nums.update(calibrate.read_only_train(prog, ref))
    assert nums["loss_gap"] < 1e-5 and nums["loss_gap_step1"] < 1e-5
    assert nums["grad_gap"] < 1e-4 and nums["grad_diff"] < 1e-4
    assert nums["half_lean"] < 1e-3
    assert nums["change_gap"] < 1e-3
    assert nums["ema_gap"] < 1e-3


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
