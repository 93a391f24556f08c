"""Build the port's native sources (``csrc/``) into shared libraries.

Each CUDA source (``*.cu``) is compiled by ``nvcc`` for ``sm_90a``, each
host source (``*.c``) by the host C compiler, into its own ``.so`` with a
plain C interface, loaded with ``ctypes``. A library is built at first use
into ``_kernels/`` beside the sources (listed in ``.gitignore``), named by
a hash of every file in ``csrc/`` and the flags, so an edited source never
loads a stale build. :func:`build` starts one compiler per source, all
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
CC_FLAGS = ("-O2", "-shared", "-fPIC")
SUFFIXES = (".cu", ".c")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# the compiler's output of the builds this process ran, by source name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                       "needs the CUDA toolkit (CUDA_HOME or PATH)")


def _cc() -> str:
    path = shutil.which("cc")
    if path is None:
        raise RuntimeError("no C compiler (cc) on PATH: the port's host "
                           "sources in csrc/ need one")
    return path


def _source(name: str) -> Path:
    for suffix in SUFFIXES:
        if (CSRC / f"{name}{suffix}").exists():
            return CSRC / f"{name}{suffix}"
    raise FileNotFoundError(f"no source csrc/{name}.cu or csrc/{name}.c")


def _command(src: Path, out: Path) -> list:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [_cc(), *CC_FLAGS, "-o", str(out), str(src)]


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + CC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in SUFFIXES + (".cuh", ".h"):
            digest.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def sources() -> list:
    return sorted(p.stem for p in CSRC.iterdir() if p.suffix in SUFFIXES)


def _build_locked(names: Iterable[str]) -> None:
    jobs = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            _command(_source(name), tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode:
            failed.append(f"{_source(name).name} (exit {proc.returncode}):"
                          f"\n{log}")
        else:
            os.replace(tmp, out)      # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile the named sources (default: all) that are not built yet,
    one compiler process each, all running at once."""
    with _lock:
        _build_locked(list(names) if names is not None else sources())


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` or ``.c``, built first if
    needed."""
    with _lock:
        if name not in _libs:
            _build_locked([name])
            _libs[name] = ctypes.CDLL(str(_library_path(name)))
        return _libs[name]
