"""Device resolution, the Flax -> PyTorch weight bridge, checkpoint-file
readers, logging, profiling and timing."""
from . import logging, misc, profiling
from .logging import KVLogger, journal
