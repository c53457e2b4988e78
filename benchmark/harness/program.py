"""The system under test: the port's ``Trainer`` (``dsdiff_torch``), built
from a configuration file's run config and given the seeded weights.

This is the one module of the harness that imports the program. It takes
from it the entry points a user calls (``Trainer.sample_fn``,
``Trainer.train_step``), the train state it reports (AdamW's first moment,
the parameters and the EMA) and a forward hook on the serving model, which
counts the model's calls and records the inputs of the requests the check
samples.
"""
from __future__ import annotations

import torch

from . import weights


def build_trainer(config: dict, seed: int, device):
    """A ``Trainer`` on ``device`` for the configuration's run config, its
    parameters filled from the seed and its state restarted from them (step
    0, zero moments, EMA = the weights)."""
    from dsdiff_torch.train.trainer import Trainer

    trainer = Trainer(dict(config["trainer"]), device=str(device))
    weights.fill(trainer.model, seed)
    trainer.reset_state()
    return trainer


class Recorder:
    """A forward hook on the serving model: counts every call, and while a
    request is recorded keeps each call's input (the chain's x joined with
    the conditions, [B, H, W, 1 + n_cond]) and the request's output."""

    def __init__(self, model: torch.nn.Module):
        self.calls = 0
        self.active = None
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, module, args, output):
        self.calls += 1
        if self.active is not None:
            self.active.append(args[0])

    def close(self):
        self.handle.remove()


def state_snapshot(trainer) -> dict:
    """{name: tensor} views of the train state after a step: the model's
    parameters, the EMA and AdamW's first moment, as the state reports
    them (``TrainState.state_dict``)."""
    sd = trainer.state.state_dict()
    return {"params": sd["params"], "ema": sd["ema"], "mu": sd["mu"]}
