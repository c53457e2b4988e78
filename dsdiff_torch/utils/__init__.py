"""Device resolution and the Flax -> PyTorch weight bridge."""
