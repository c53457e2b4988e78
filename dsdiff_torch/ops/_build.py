"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into ``dsdiff_torch/_build/lib<name>-<hash>.so`` and loaded
with ``ctypes``; the hash covers the source and the flags, so an edited
source is rebuilt. ``nvcc``'s ``-Xptxas -v`` report (registers, shared
memory, spills) is kept beside the library as ``.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build", "build_all", "load"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    (process or None, library path, temporary output path)."""
    lib = _lib_path(name)
    if lib.exists():
        return None, lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib, tmp


def _finish(name: str, proc, lib: Path, tmp: Path) -> Path:
    if proc is None:
        return lib
    log, _ = proc.communicate()
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib


def build(name: str) -> Path:
    """Build ``csrc/<name>.cu`` if needed; returns the library path."""
    return _finish(name, *_start(name))


def build_all() -> dict[str, Path]:
    """Build every ``csrc/*.cu``, one ``nvcc`` per source, all at once."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    started = {}
    try:
        for n in names:
            started[n] = _start(n)
        return {n: _finish(n, *started[n]) for n in names}
    finally:  # after a failure, stop the builds still running
        for proc, _, _ in started.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
