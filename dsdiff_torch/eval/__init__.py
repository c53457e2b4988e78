"""Evaluation metrics computed on the device."""
