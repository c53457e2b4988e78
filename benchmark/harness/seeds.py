"""Seeds derived from the run's ``--seed``: one stream per purpose, so that
the weights, the inputs and the sample of requests checked never share
draws. ``--seed`` may be any whole number up to a little over 2**31 (and
larger)."""
from __future__ import annotations

import numpy as np

PURPOSES = {"weights": 1, "inputs": 2, "feed": 3, "checked": 4}


def sub_seed(seed: int, purpose: str) -> int:
    words = np.random.SeedSequence([int(seed) & (2**64 - 1),
                                    PURPOSES[purpose]]).generate_state(2)
    return (int(words[0]) << 31) ^ int(words[1])
