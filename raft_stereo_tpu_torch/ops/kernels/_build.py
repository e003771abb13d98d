"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one source under ``raft_stereo_tpu_torch/csrc/`` with a
plain C interface, and may include the shared headers (``csrc/*.cuh``).
It is compiled for Hopper (``sm_90a``) into a shared library under
``raft_stereo_tpu_torch/build/`` at first use, named by the hash of its
source, the headers and the flags, so a changed source or header is
rebuilt and an unchanged one is loaded as it is. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from "
                       f"{CSRC_DIR} at first use")


def library_path(name: str) -> str:
    """Where kernel ``name`` is built: keyed by its source, the shared
    headers and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for kernel ``name``; returns (popen, tmp, final, log) or
    None when the library is already built."""
    final = library_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    log = open(f"{tmp}.log", "w+")  # a file: nvcc never blocks on a pipe
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, final, log


def _finish_build(name: str, job) -> None:
    proc, tmp, final, log = job
    proc.wait()
    log.seek(0)
    out = log.read()
    log.close()
    os.remove(log.name)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed to build kernel {name!r} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, final)  # atomic: a reader never sees a partial library


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Build every kernel in ``names`` with one nvcc each, all started
    together; raises with nvcc's output if any build fails. Returns each
    built kernel's seconds from the common start to its nvcc's exit (an
    already built kernel is left out)."""
    start = time.perf_counter()
    jobs = {name: _start_build(name) for name in names}
    pending = {name: job for name, job in jobs.items() if job is not None}
    seconds: Dict[str, float] = {}
    while pending:
        for name, job in list(pending.items()):
            if job[0].poll() is not None:
                seconds[name] = time.perf_counter() - start
                del pending[name]
        time.sleep(0.05)
    errors = []
    for name, job in jobs.items():
        if job is None:
            continue
        try:
            _finish_build(name, job)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib
