"""Data-parallel and ZeRO-sharded training over ``torch.distributed``."""
