"""Entry points: ``python -m dsdiff_torch.cli.train`` and ``.sample``."""
