"""Evaluation: metrics, volume assembly and reports, figures."""
