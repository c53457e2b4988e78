"""The PyTorch / CUDA port's benchmark (``python3 benchmark/run.py``)."""
