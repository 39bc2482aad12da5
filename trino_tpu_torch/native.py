"""The port's native host tier: ctypes bindings for ``csrc/columnar.cpp``.

Reference: ``trino_tpu/native/__init__.py`` (``_build_and_load``,
``dict_encode``, ``tpch_textpool``), restricted to the symbols the port
calls. The port keeps its own copy of the C++ those two symbols need
(``trino_tpu_torch/csrc/columnar.cpp``) and reads no source of the
reference's tiers. It is compiled at first use with ``g++ -O3 -shared
-fPIC -std=c++17`` into ``.kernel_build/native/columnar_<sha256>.so`` at
the repository root (listed in ``.gitignore``) and rebuilt when the
source changes.

Unlike the reference there is no pure-Python fallback: when ``g++`` is
missing or fails, the first call raises :class:`NativeCompileError` with the
compiler's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "columnar.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".kernel_build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeCompileError(RuntimeError):
    """``csrc/columnar.cpp`` could not be built or loaded."""


def library_path() -> Path:
    """Where the shared library for the current source lives."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"columnar_{digest}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeCompileError(f"{' '.join(cmd)} could not run: {e}") from e
    if proc.returncode != 0:
        raise NativeCompileError(
            f"{' '.join(cmd)} failed (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, path)


def load() -> ctypes.CDLL:
    """The loaded library, built first when needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeCompileError(f"cannot load {path}: {e}") from e
        i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
        lib.tt_dict_encode.restype = i64
        lib.tt_dict_encode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), i64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tt_tpch_textpool.restype = i64
        lib.tt_tpch_textpool.argtypes = [u8p, i64, u8p, i64, i64]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def dict_encode(strings: Sequence[str]) -> tuple[np.ndarray, list[str]]:
    """int32 codes and the unique values in first-seen order (the native
    hash table ``tt_dict_encode``)."""
    n = len(strings)
    if n == 0:
        return np.zeros(0, dtype=np.int32), []
    lib = load()
    enc = [s.encode("utf-8", "surrogatepass") for s in strings]
    lengths = np.fromiter((len(e) for e in enc), dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    codes = np.empty(n, dtype=np.int32)
    first = np.empty(n, dtype=np.int64)
    n_unique = lib.tt_dict_encode(
        b"".join(enc), _ptr(offsets, ctypes.c_int64), n,
        _ptr(codes, ctypes.c_int32), _ptr(first, ctypes.c_int64),
    )
    return codes, [strings[i] for i in first[:n_unique].tolist()]


def tpch_textpool(size: int, dists_blob: bytes, seed: int) -> np.ndarray:
    """The dbgen grammar text pool (uint8 array of ``size`` bytes)."""
    lib = load()
    out = np.empty(size, dtype=np.uint8)
    blob = np.frombuffer(dists_blob, dtype=np.uint8)
    got = lib.tt_tpch_textpool(
        _ptr(out, ctypes.c_uint8), size, _ptr(blob, ctypes.c_uint8),
        len(dists_blob), seed,
    )
    if got != size:
        raise ValueError(f"text pool generation failed ({got} of {size} bytes)")
    return out
