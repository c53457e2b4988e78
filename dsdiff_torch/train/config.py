"""Two-tier YAML config: a run config merged with a model config.

The port's own copy of the JAX package's ``train/config.py``: an attribute dict
with recursive merge. PyYAML is imported only inside ``load_config``, so the
rest of the port runs where it is not installed.
"""
from __future__ import annotations

import copy
from pathlib import Path

__all__ = ["Config", "load_config", "merge", "load_run_config"]


class Config(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)

    def get_path(self, dotted: str, default=None):
        cur = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur


def load_config(path) -> Config:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return Config.wrap(data)


def merge(base: dict, override: dict) -> Config:
    """Recursive merge; override wins (OmegaConf.merge semantics)."""
    out = copy.deepcopy(dict(base))
    for k, v in (override or {}).items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return Config.wrap(out)


def load_run_config(run_path, model_path=None, overrides: dict | None = None):
    """run YAML (+ optional model YAML referenced by ``config_opt`` or given
    explicitly) -> merged Config."""
    cfg = load_config(run_path)
    mp = model_path or cfg.get("config_opt")
    if mp:
        mp = Path(mp)
        if not mp.is_absolute():
            mp = Path(run_path).parent / mp
        cfg = merge(cfg, load_config(mp))
    if overrides:
        cfg = merge(cfg, overrides)
    return cfg
