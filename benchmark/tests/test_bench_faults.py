"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip and drives the rest of a run
(``harness.runner.run``) on the CPU at a tiny size, under the cell's own
limits: first sound, which must come out correct, then with one fault
planted in the program, which must not. The program runs in f32 here:
at this size its bf16 rounding is a larger share of what it computes than
at the cell's widths, which the limits were set at. Faults: a serve request whose
answer is altered where it is produced, or whose chain returns its start
unchanged; a train step that leaves the state unchanged, or that leaves
half of the batch out and takes the mean over the rest. (One chip: there
is no exchange between chips to leave out.)
"""
import time

import pytest
import torch

from benchmark.calibrate import half_batch_fault
from benchmark.harness import runner
from tiny import tiny_cell

SEED = 2**31 + 101


def run(cell):
    torch.manual_seed(0)
    return runner.run(cell, SEED, 0.5, False, "cpu", time.perf_counter())


def _ddim_wrapped(monkeypatch, after):
    from dsdiff_torch.core import sampling

    real = sampling.SAMPLERS["ddim"]

    def loop(sched, denoise_fn, x_T, **kw):
        return after(real(sched, denoise_fn, x_T, **kw), x_T)

    monkeypatch.setitem(sampling.SAMPLERS, "ddim", loop)


def _altered(out, x_T):
    out = out.clone()
    out[0, :8, :8, 0] += 0.25
    return out


@pytest.mark.parametrize("cell_name", ["flagship-serve-b8", "discdiff-serve-b8"])
@pytest.mark.parametrize("fault", ["answer_altered", "state_unchanged"])
def test_serve_fault_is_not_correct(cell_name, fault, monkeypatch):
    cell = tiny_cell(cell_name, bf16=False)
    assert run(cell)["correct"]
    after = _altered if fault == "answer_altered" else (lambda out, x_T: x_T)
    _ddim_wrapped(monkeypatch, after)
    res = run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_fault_is_not_correct(fault, monkeypatch):
    cell = tiny_cell("flagship-train-b32", batch=4, bf16=False)
    assert run(cell)["correct"]
    if fault == "state_unchanged":
        from dsdiff_torch.train.state import TrainState

        monkeypatch.setattr(TrainState, "apply_gradients",
                            lambda self, grads: None)
        res = run(cell)
    else:
        with half_batch_fault():
            res = run(cell)
    assert not res["correct"], res["checks"]
