"""Diffusion schedules, the Gaussian process and the samplers."""
