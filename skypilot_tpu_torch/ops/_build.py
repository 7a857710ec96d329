"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use with ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the repository root, then loaded with
``ctypes``. The library name carries a hash of the source, of every
shared header ``csrc/*.cuh`` and of the flags, so an edited kernel or
header rebuilds and a stale library is never loaded. A failed build
raises.

:func:`build_all` starts one ``nvcc`` per source together, so the build
takes as long as the slowest file. :func:`start` launches them and
returns at once, so a caller can work beside a slow file's build; a
later :func:`build_all` or :func:`load` of that source waits for it,
and :func:`stop` ends the builds nobody waited for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("paged_attention", "flash_fwd", "flash_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Builds started by :func:`start` and not finished yet: {name: (process,
# temporary library, library)}.
_pending: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    # A session of its own: :func:`stop` ends nvcc with the compilers
    # it runs.
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def start(names=SOURCES) -> None:
    """Start ``nvcc`` for every listed source that is neither built nor
    building, and return without waiting."""
    with _lock:
        for n in names:
            if n not in _pending:
                st = _start(n)
                if st is not None:
                    _pending[n] = st


def stop() -> None:
    """End the builds :func:`start` began that nobody waited for, and
    remove their partial output."""
    with _lock:
        while _pending:
            _, (proc, tmp, _out) = _pending.popitem()
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.communicate()
            tmp.unlink(missing_ok=True)


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every listed kernel source that is not built yet, all
    ``nvcc`` processes at once, a build :func:`start` began included.
    Returns {name: compiler output}."""
    with _lock:
        started = [(n, _pending.pop(n, None) or _start(n)) for n in names]
        logs = {}
        errors: List[str] = []
        for n, st in started:
            try:
                logs[n] = _finish(n, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
