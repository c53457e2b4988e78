"""KV metric logger with human/CSV/JSONL writers + run journal.

The port's own copy of the JAX package's ``utils/logging.py``.

Re-design of the OpenAI logger (Disc_diff/guided_diffusion/logger.py:36-190):
``logkv``/``logkv_mean``/``dumpkvs`` with Human, CSV and JSONL sinks, minus
the MPI-weighted means (metrics arriving here are already reduced). The plain-text run journal mirrors ``print_to_txt``'s log_txt.txt
(trainers/trainer_ds_diff.py:207-210). TensorBoard is intentionally not a
dependency; JSONL is the machine-readable stream.
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

__all__ = ["KVLogger", "journal"]


class KVLogger:
    def __init__(self, log_dir=None, formats=("human", "jsonl", "csv"),
                 stream=None):
        self.log_dir = Path(log_dir) if log_dir else None
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
        self.formats = formats
        self.stream = stream or sys.stdout
        self._vals: dict = {}
        self._counts: dict = defaultdict(int)
        self._csv_keys: list | None = None
        self._t0 = time.time()

    def logkv(self, key, value):
        self._vals[key] = float(value)
        self._counts[key] = 1

    def logkv_mean(self, key, value):
        """Running mean within a dump interval (logger.py:81-88)."""
        n = self._counts[key]
        old = self._vals.get(key, 0.0)
        self._vals[key] = (old * n + float(value)) / (n + 1)
        self._counts[key] = n + 1

    def dumpkvs(self) -> dict:
        out = dict(self._vals)
        out["_wall_s"] = round(time.time() - self._t0, 2)
        if "human" in self.formats:
            parts = " | ".join(
                f"{k} {v:.5g}" for k, v in sorted(out.items())
                if not k.startswith("_")
            )
            print(parts, file=self.stream, flush=True)
        if self.log_dir:
            if "jsonl" in self.formats:
                with open(self.log_dir / "progress.jsonl", "a") as f:
                    f.write(json.dumps(out) + "\n")
            if "csv" in self.formats:
                self._dump_csv(out)
        self._vals.clear()
        self._counts.clear()
        return out

    def _dump_csv(self, row: dict):
        path = self.log_dir / "progress.csv"
        keys = sorted(row)
        if self._csv_keys != keys:
            # rewrite with the superset header (logger.py CSV writer behavior)
            old_rows = []
            if path.exists():
                import csv as _csv

                with open(path) as f:
                    old_rows = list(_csv.DictReader(f))
            self._csv_keys = sorted(
                set(keys)
                | {k for r in old_rows for k in r}
            )
            with open(path, "w", newline="") as f:
                import csv as _csv

                w = _csv.DictWriter(f, fieldnames=self._csv_keys)
                w.writeheader()
                for r in old_rows:
                    w.writerow(r)
        import csv as _csv

        with open(path, "a", newline="") as f:
            w = _csv.DictWriter(f, fieldnames=self._csv_keys)
            w.writerow({k: row.get(k, "") for k in self._csv_keys})


def journal(log_dir, *message):
    """Append a timestamped line to log_txt.txt (print_to_txt parity)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    line = time.strftime("[%Y-%m-%d %H:%M:%S] ") + " ".join(
        str(m) for m in message
    )
    with open(log_dir / "log_txt.txt", "a") as f:
        f.write(line + "\n")
    return line
