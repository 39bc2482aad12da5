"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``. Builds happen at first use, from the sources in this checkout
only, into ``.kernel_build/`` at the repository root (listed in
``.gitignore``); a library is rebuilt when its source changes, and what
``nvcc -Xptxas -v`` printed is kept beside it (:func:`build_log`).
:func:`build_all` starts one ``nvcc`` per source, all at once.

Every kernel wrapper counts its launches in :data:`LAUNCHES` and its
plain-version runs on CPU tensors in :data:`PLAIN_CALLS`, so a run can show
which path it took. A count is one call of the kernel's C entry point, made
where the wrapper launches it and nowhere else: one group-by for
``dense_groupby`` (one grid per launch group, one for every plan of the
main path), one whole table build for ``dense_join_build`` (at most six
launches on one stream). A CUDA graph's replay launches the kernels its
capture recorded and counts them as its capture did (:func:`count_replay`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".kernel_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
]

# kernel name -> C entry point and its ctypes signature
_ENTRY = {
    "dense_groupby": (
        "tt_dense_groupby",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p],
    ),
    "dense_join_build": (
        "tt_dense_join_build",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_int]
        + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p],
    ),
}

# kernel name -> C function run once when the library loads (launch facts
# that a launch inside a CUDA graph capture may not query)
_INIT = {"dense_join_build": "tt_dense_join_build_init"}

LAUNCHES: dict[str, int] = {name: 0 for name in _ENTRY}
PLAIN_CALLS: dict[str, int] = {name: 0 for name in _ENTRY}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def count_replay(launches: dict[str, int]) -> None:
    """Count the kernel launches of one CUDA graph replay: a graph
    (``exec/programs.py``) launches again every kernel its capture
    recorded, without passing through the wrappers, so each replay adds
    the launches its capture counted."""
    for name, n in launches.items():
        LAUNCHES[name] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build kernels")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp, out) or None when
    the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every kernel source that is not built yet, one nvcc process
    per source, all started together."""
    with _lock:
        jobs = {name: _start_build(name) for name in _ENTRY}
        for name, job in jobs.items():
            if job is not None:
                _finish_build(name, job)


def build_log(name: str) -> str:
    """What nvcc and ptxas printed when kernel ``name`` was built."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built at first use)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            lib = ctypes.CDLL(str(_lib_path(name)))
            symbol, argtypes = _ENTRY[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            if name in _INIT:
                init = getattr(lib, _INIT[name])
                init.restype = ctypes.c_int
                check(name, init())
            _loaded[name] = lib
    return lib


def entry(name: str):
    """The C entry point of kernel ``name``."""
    return getattr(load(name), _ENTRY[name][0])


def check(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
