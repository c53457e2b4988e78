"""The control, on the card at each cell's own size and on three seeds:
the reference one precision step below the configuration's, or the
program's own lower-precision path, must come out not correct under the
cell's limits (for a serve cell the program with its int8 path on; for a
train cell the reference in fp8 in the program's place), and so must the
half-batch fault of the train cell. Run on the card:

    python -m pytest -m gpu benchmark/tests/test_bench_control_gpu.py
"""
import pytest

from benchmark import calibrate
from benchmark.harness import check, program, spec

SEEDS = (3_000_000_019, 3_000_000_023, 3_000_000_029)
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _fails(cell, numbers) -> bool:
    ok, _ = check.compare(numbers, cell.limits)
    return not ok


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, card):
    cell = spec.load_cell(name)
    trainer = program.build_trainer(cell.config, 0, card)
    for seed in SEEDS:
        if cell.traffic["kind"] == "serve":
            nums = calibrate.serve_reading(trainer, cell, seed, card, int8=True)
        else:
            nums = calibrate.train_reading(trainer, cell, seed, card,
                                           control=True)
        assert _fails(cell, nums), (seed, nums)


@pytest.mark.gpu
def test_half_batch_fault_is_not_correct(card):
    cell = spec.load_cell("flagship-train-b32")
    trainer = program.build_trainer(cell.config, 0, card)
    for seed in SEEDS:
        nums = calibrate.train_reading(trainer, cell, seed, card,
                                       half_batch=True)
        assert _fails(cell, nums), (seed, nums)
