"""The inputs of a run, drawn from its seed on the device in a few large
calls: a pool of requests (conditions uniform in [-1, 1], x_T standard
normal) for a serve mix, and for a train mix a pool of rows (target and
conditions uniform in [-1, 1]) with each step's t and noise drawn as it is
fed. Every seed gives the same sizes; only the values differ."""
from __future__ import annotations

import torch

from .seeds import sub_seed


def _uniform(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0


class ServePool:
    """``pool_requests`` requests of ``batch`` slices; request i is pool
    entry ``i % pool_requests``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        size = int(config["trainer"]["image_size"])
        B, P = int(traffic["batch"]), int(traffic["pool_requests"])
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "inputs"))
        self.cond = _uniform((P, B, size, size, int(config["n_cond"])), gen,
                             device)
        self.x_T = torch.randn((P, B, size, size, 1), generator=gen,
                               device=device)
        self.size = P

    def request(self, i: int):
        p = i % self.size
        return self.cond[p], self.x_T[p]


class TrainFeed:
    """Batches of ``batch`` rows from a pool of ``pool_batches`` batches,
    in order, so that consecutive steps see different rows; each step's t
    (uniform over the diffusion steps) and noise are drawn from the feed's
    generator when the step is fed. ``next()`` returns (batch dict, t,
    noise)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        size = int(config["trainer"]["image_size"])
        B, P = int(traffic["batch"]), int(traffic["pool_batches"])
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "inputs"))
        self.target = _uniform((P * B, size, size, 1), gen, device)
        self.image = _uniform((P * B, size, size, int(config["n_cond"])), gen,
                              device)
        self.gen = torch.Generator(device=device).manual_seed(
            sub_seed(seed, "feed"))
        self.T = int(config["trainer"].get("diffusion_steps", 1000))
        self.B, self.P, self.device = B, P, device
        self.fed = 0

    def next(self):
        k = self.fed % self.P
        self.fed += 1
        rows = slice(k * self.B, (k + 1) * self.B)
        batch = {"target": self.target[rows], "image": self.image[rows]}
        t = torch.randint(0, self.T, (self.B,), generator=self.gen,
                          device=self.device)
        noise = torch.randn(batch["target"].shape, generator=self.gen,
                            device=self.device)
        return batch, t, noise
