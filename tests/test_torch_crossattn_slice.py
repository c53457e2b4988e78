"""The transformer conditioning path as a whole for ``fusion: crossattn``: DSUNet's cross-attention fusion, against
the JAX ``Trainer`` given its draws (``torch_transformer_slice``)."""
import pytest

from torch_parity_utils import one_thread
from torch_transformer_slice import (  # noqa: F401  (collected here)
    pair,
    test_sample_fn_matches_jax_given_its_x_T,
    test_the_config_builds_the_transformer_path,
    test_train_step_matches_jax_given_its_draws,
)

pytestmark = pytest.mark.usefixtures("one_thread")

RUN = "crossattn"
