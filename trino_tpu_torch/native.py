"""The port's native host tier: ctypes bindings for ``csrc/columnar.cpp``.

Reference: ``trino_tpu/native/__init__.py``. The port keeps its own copy
of every entry point of the reference's C++
(``trino_tpu_torch/csrc/columnar.cpp``) and reads no source of the
reference's tiers. It is compiled at first use with ``g++ -O3 -shared
-fPIC -std=c++17`` into ``.kernel_build/native/columnar_<sha256>.so`` at
the repository root (listed in ``.gitignore``) and rebuilt when the
source changes. When ``g++`` is missing or fails, the first native call
raises :class:`NativeCompileError` with the compiler's stderr: there is
no silent fallback on a failed build.

Beside each binding stands its NumPy/Python version (the reference's,
but for LZ, where the reference's zlib stream is replaced by the C codec
transcribed so both versions read each other's pages). The session
property ``native_decode=false`` selects the NumPy versions for one
scan: the executor enters :func:`decode_mode` around its split reads,
which sets a context variable of the calling context only (the split
prefetcher carries it into its thread). Other threads keep their own
mode, unlike the reference's ``python_fallback``, which swaps the module
handle for every thread. The ORC decoders and encoders return ``None``
in NumPy mode, and ``formats/orc.py`` runs its own NumPy codecs, as in
the reference.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "columnar.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".kernel_build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# True: the C entry points; False: their NumPy versions (per context)
_NATIVE = contextvars.ContextVar("trino_tpu_torch_native_decode", default=True)


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


_SIGNATURES = {
    # name: (restype, argtypes), with the C types spelled below
    "tt_dict_encode": ("i64", ["char*", "i64*", "i64", "i32*", "i64*"]),
    "tt_varint_encode": ("i64", ["i64*", "i64", "u8*"]),
    "tt_varint_decode": ("i64", ["u8*", "i64", "i64", "i64*"]),
    "tt_rle_encode": ("i64", ["i64*", "i64", "u8*"]),
    "tt_rle_decode": ("i64", ["u8*", "i64", "i64", "i64*"]),
    "tt_bitpack_encode": ("i64", ["u64*", "i64", "i32", "u8*"]),
    "tt_bitpack_decode": (None, ["u8*", "i64", "i32", "u64*"]),
    "tt_lz_compress": ("i64", ["u8*", "i64", "u8*"]),
    "tt_lz_decompress": ("i64", ["u8*", "i64", "u8*", "i64"]),
    "tt_snappy_decompress": ("i64", ["u8*", "i64", "u8*", "i64"]),
    "tt_snappy_compress": ("i64", ["u8*", "i64", "u8*"]),
    "tt_parquet_rle_decode": ("i64", ["u8*", "i64", "i32", "i64", "i32*"]),
    "tt_parquet_rle_encode": ("i64", ["i32*", "i64", "i32", "u8*"]),
    "tt_tpch_textpool": ("i64", ["u8*", "i64", "u8*", "i64", "i64"]),
    "tt_orc_rle2": ("i64", ["u8*", "i64", "i64", "i32", "i64*"]),
    "tt_orc_rle1": ("i64", ["u8*", "i64", "i64", "i32", "i64*"]),
    "tt_orc_byte_rle": ("i64", ["u8*", "i64", "i64", "u8*"]),
    "tt_orc_decimal64": ("i64", ["u8*", "i64", "i64", "i64*"]),
    "tt_orc_rle2_encode": ("i64", ["i64*", "i64", "i32", "u8*"]),
    "tt_orc_byte_rle_encode": ("i64", ["u8*", "i64", "u8*"]),
    "tt_orc_varint_encode": ("i64", ["u64*", "i64", "u8*"]),
    "tt_pack_arena": ("i64", ["void**", "i64*", "i64", "u8*", "i64"]),
    "tt_scatter_segments": ("i64", ["void**", "i64*", "i64*", "i64", "u8*", "i64"]),
}
_CTYPES = {
    "i64": ctypes.c_int64, "i32": ctypes.c_int32, "char*": ctypes.c_char_p,
    "i64*": ctypes.POINTER(ctypes.c_int64), "i32*": ctypes.POINTER(ctypes.c_int32),
    "u8*": ctypes.POINTER(ctypes.c_uint8), "u64*": ctypes.POINTER(ctypes.c_uint64),
    "void**": ctypes.POINTER(ctypes.c_void_p), None: None,
}


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
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = _CTYPES[res]
            fn.argtypes = [_CTYPES[a] for a in args]
        _lib = lib
        return lib


def _active() -> Optional[ctypes.CDLL]:
    """The library in native mode (built first when needed), else None."""
    return load() if _NATIVE.get() else None


def native_mode() -> bool:
    """Whether this context decodes with the C entry points."""
    return _NATIVE.get()


@contextlib.contextmanager
def decode_mode(native: bool):
    """Decode with the C entry points (``True``) or their NumPy versions
    (``False``) in this context for the block's duration (the session
    property ``native_decode`` of one scan)."""
    token = _NATIVE.set(bool(native))
    try:
        yield
    finally:
        _NATIVE.reset(token)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# === dictionary encode ======================================================


def dict_encode(strings: Sequence[str]) -> tuple[np.ndarray, list[str]]:
    """int32 codes and the unique values in first-seen order (the native
    hash table ``tt_dict_encode``)."""
    n = len(strings)
    if n == 0:
        return np.zeros(0, dtype=np.int32), []
    if (lib := _active()) is not None:
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
    index: dict[str, int] = {}
    codes = np.empty(n, dtype=np.int32)
    uniques: list[str] = []
    for i, s in enumerate(strings):
        c = index.get(s)
        if c is None:
            c = len(uniques)
            index[s] = c
            uniques.append(s)
        codes[i] = c
    return codes, uniques


def tpch_textpool(size: int, dists_blob: bytes, seed: int) -> np.ndarray:
    """The dbgen grammar text pool (uint8 array of ``size`` bytes). Always
    native: callers cache the pool on disk, and the Python generator
    (``dbgen.textpool_python``) takes minutes for the whole pool."""
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


# === integer codecs =========================================================


def varint_encode(values: np.ndarray) -> bytes:
    values = np.ascontiguousarray(values, dtype=np.int64)
    n = len(values)
    if n == 0:
        return b""
    if (lib := _active()) is not None:
        out = np.empty(10 * n, dtype=np.uint8)
        ln = lib.tt_varint_encode(
            _ptr(values, ctypes.c_int64), n, _ptr(out, ctypes.c_uint8)
        )
        return out[:ln].tobytes()
    # delta + zigzag varint in Python; the delta wraps at 64 bits as in C
    # (the reference's Python version does not, and differs from its
    # native one where a delta overflows)
    out = bytearray()
    prev = 0
    for v in values.tolist():
        d = ((v - prev + (1 << 63)) & ((1 << 64) - 1)) - (1 << 63)
        u = ((d << 1) ^ (d >> 63)) & ((1 << 64) - 1)
        prev = v
        while u >= 0x80:
            out.append((u & 0x7F) | 0x80)
            u >>= 7
        out.append(u)
    return bytes(out)


def varint_decode(data: bytes, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if (lib := _active()) is not None:
        buf = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(n, dtype=np.int64)
        rc = lib.tt_varint_decode(
            _ptr(buf, ctypes.c_uint8), len(buf), n, _ptr(out, ctypes.c_int64)
        )
        if rc < 0:
            raise ValueError("corrupt varint page")
        return out
    out = np.empty(n, dtype=np.int64)
    pos = 0
    prev = 0
    for i in range(n):
        u = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            u |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        d = (u >> 1) ^ -(u & 1)
        prev = ((prev + d + (1 << 63)) & ((1 << 64) - 1)) - (1 << 63)
        out[i] = prev
    return out


def rle_encode(values: np.ndarray) -> bytes:
    values = np.ascontiguousarray(values, dtype=np.int64)
    n = len(values)
    if n == 0:
        return b""
    if (lib := _active()) is not None:
        out = np.empty(20 * n + 16, dtype=np.uint8)
        ln = lib.tt_rle_encode(
            _ptr(values, ctypes.c_int64), n, _ptr(out, ctypes.c_uint8)
        )
        return out[:ln].tobytes()
    out = bytearray()
    i = 0
    vals = values.tolist()
    while i < n:
        run = 1
        while i + run < n and vals[i + run] == vals[i]:
            run += 1
        for u in (run, (vals[i] << 1) ^ (vals[i] >> 63) if vals[i] < 0 else vals[i] << 1):
            u &= (1 << 64) - 1
            while u >= 0x80:
                out.append((u & 0x7F) | 0x80)
                u >>= 7
            out.append(u)
        i += run
    return bytes(out)


def rle_decode(data: bytes, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if (lib := _active()) is not None:
        buf = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(n, dtype=np.int64)
        rc = lib.tt_rle_decode(
            _ptr(buf, ctypes.c_uint8), len(buf), n, _ptr(out, ctypes.c_int64)
        )
        if rc < 0:
            raise ValueError("corrupt RLE page")
        return out
    out = np.empty(n, dtype=np.int64)
    pos = 0
    i = 0
    while i < n:
        parts = []
        for _ in range(2):
            u = 0
            shift = 0
            while True:
                b = data[pos]
                pos += 1
                u |= (b & 0x7F) << shift
                if not (b & 0x80):
                    break
                shift += 7
            parts.append(u)
        run, u = parts
        v = (u >> 1) ^ -(u & 1)
        for _ in range(run):
            if i < n:
                out[i] = v
                i += 1
    return out


def bitpack_encode(values: np.ndarray, width: int) -> bytes:
    values = np.ascontiguousarray(values, dtype=np.uint64)
    n = len(values)
    if n == 0 or width == 0:
        return b""
    if (lib := _active()) is not None:
        out = np.zeros((n * width + 7) // 8, dtype=np.uint8)
        lib.tt_bitpack_encode(
            _ptr(values, ctypes.c_uint64), n, width, _ptr(out, ctypes.c_uint8)
        )
        return out.tobytes()
    bits = np.zeros(n * width, dtype=np.uint8)
    for b in range(width):
        bits[b::width] = (values >> np.uint64(b)) & np.uint64(1)
    return np.packbits(bits, bitorder="little").tobytes()


def bitpack_decode(data: bytes, n: int, width: int) -> np.ndarray:
    if n == 0 or width == 0:
        return np.zeros(n, dtype=np.uint64)
    if (lib := _active()) is not None:
        buf = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(n, dtype=np.uint64)
        lib.tt_bitpack_decode(
            _ptr(buf, ctypes.c_uint8), n, width, _ptr(out, ctypes.c_uint64)
        )
        return out
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8), bitorder="little")
    bits = bits[: n * width].reshape(n, width).astype(np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for b in range(width):
        out |= bits[:, b] << np.uint64(b)
    return out


def snappy_decompress(data: bytes, expected_len: int) -> bytes:
    """Snappy block format (Parquet's default codec). Python fallback
    implements the same tagged literal/copy stream."""
    if not data:
        return b""
    if (lib := _active()) is not None:
        inp = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(max(expected_len, 1), dtype=np.uint8)
        ln = lib.tt_snappy_decompress(
            _ptr(inp, ctypes.c_uint8), len(data), _ptr(out, ctypes.c_uint8),
            max(expected_len, 1),
        )
        if ln < 0:
            raise ValueError("corrupt snappy page")
        return out[:ln].tobytes()
    # pure-python fallback
    ip = 0
    ulen = 0
    shift = 0
    while True:
        b = data[ip]
        ip += 1
        ulen |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    out = bytearray()
    n = len(data)
    while ip < n:
        tag = data[ip]
        ip += 1
        kind = tag & 3
        if kind == 0:
            ln = (tag >> 2) + 1
            if (tag >> 2) >= 60:
                nb = (tag >> 2) - 59
                ln = int.from_bytes(data[ip : ip + nb], "little") + 1
                ip += nb
            out += data[ip : ip + ln]
            ip += ln
        else:
            if kind == 1:
                ln = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | data[ip]
                ip += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[ip : ip + 2], "little")
                ip += 2
            else:
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[ip : ip + 4], "little")
                ip += 4
            for _ in range(ln):
                out.append(out[-off])
    return bytes(out)


def snappy_compress(data: bytes) -> bytes:
    """Literal-only snappy stream (valid for any decoder)."""
    if (lib := _active()) is not None and data:
        inp = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(len(data) + len(data) // 64 + 32, dtype=np.uint8)
        ln = lib.tt_snappy_compress(
            _ptr(inp, ctypes.c_uint8), len(data), _ptr(out, ctypes.c_uint8)
        )
        return out[:ln].tobytes()
    out = bytearray()
    ulen = len(data)
    while ulen >= 0x80:
        out.append((ulen & 0x7F) | 0x80)
        ulen >>= 7
    out.append(ulen)
    ip = 0
    while ip < len(data):
        chunk = min(len(data) - ip, 65536)
        ln = chunk - 1
        if ln < 60:
            out.append(ln << 2)
        else:
            out.append(61 << 2)  # 61 => two length bytes
            out += (ln).to_bytes(2, "little")
        out += data[ip : ip + chunk]
        ip += chunk
    return bytes(out)


def parquet_rle_decode(data: bytes, bit_width: int, n: int) -> np.ndarray:
    """Parquet RLE/bit-packed hybrid (def levels, dictionary indices)."""
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    if bit_width == 0:
        return np.zeros(n, dtype=np.int32)
    if (lib := _active()) is not None:
        buf = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(n, dtype=np.int32)
        rc = lib.tt_parquet_rle_decode(
            _ptr(buf, ctypes.c_uint8), len(buf), bit_width, n,
            _ptr(out, ctypes.c_int32),
        )
        if rc < 0:
            raise ValueError("corrupt parquet RLE run")
        return out
    out = np.empty(n, dtype=np.int32)
    ip = 0
    op = 0
    byte_width = (bit_width + 7) // 8
    while op < n and ip < len(data):
        header = 0
        shift = 0
        while True:
            b = data[ip]
            ip += 1
            header |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        if header & 1:
            count = (header >> 1) * 8
            acc = 0
            acc_bits = 0
            mask = (1 << bit_width) - 1
            for _ in range(count):
                while acc_bits < bit_width and ip < len(data):
                    acc |= data[ip] << acc_bits
                    ip += 1
                    acc_bits += 8
                if op < n:
                    out[op] = acc & mask
                    op += 1
                acc >>= bit_width
                acc_bits -= bit_width
        else:
            count = header >> 1
            v = int.from_bytes(data[ip : ip + byte_width], "little")
            ip += byte_width
            for _ in range(count):
                if op < n:
                    out[op] = v
                    op += 1
    return out


def parquet_rle_encode(values: np.ndarray, bit_width: int) -> bytes:
    values = np.ascontiguousarray(values, dtype=np.int32)
    n = len(values)
    if n == 0:
        return b""
    if (lib := _active()) is not None:
        out = np.empty(n * 8 + 16, dtype=np.uint8)
        ln = lib.tt_parquet_rle_encode(
            _ptr(values, ctypes.c_int32), n, bit_width, _ptr(out, ctypes.c_uint8)
        )
        return out[:ln].tobytes()
    out = bytearray()
    byte_width = (bit_width + 7) // 8
    i = 0
    vals = values.tolist()
    while i < n:
        j = i
        while j < n and vals[j] == vals[i]:
            j += 1
        header = (j - i) << 1
        while header >= 0x80:
            out.append((header & 0x7F) | 0x80)
            header >>= 7
        out.append(header)
        out += int(vals[i] & 0xFFFFFFFF).to_bytes(4, "little")[:byte_width]
        i = j
    return bytes(out)


def lz_compress(data: bytes) -> bytes:
    """The byte-LZ stream of ``tt_lz_compress`` (the pages codec)."""
    if not data:
        return b""
    if (lib := _active()) is not None:
        inp = np.frombuffer(data, dtype=np.uint8)
        # worst case: all literals -> n + n/128 + 1 token bytes
        out = np.empty(len(data) + len(data) // 128 + 16, dtype=np.uint8)
        ln = lib.tt_lz_compress(
            _ptr(inp, ctypes.c_uint8), len(data), _ptr(out, ctypes.c_uint8)
        )
        return out[:ln].tobytes()
    # the same greedy matcher in Python (the reference falls back to zlib
    # here, a stream its native decoder cannot read)
    n = len(data)
    table = [-1] * (1 << 16)
    out = bytearray()
    i = lit_start = 0

    def flush(end):
        nonlocal lit_start
        while lit_start < end:
            take = min(end - lit_start, 128)
            out.append(take - 1)
            out.extend(data[lit_start : lit_start + take])
            lit_start += take

    while i + 4 <= n:
        key = int.from_bytes(data[i : i + 4], "little")
        h = ((key * 2654435761) & 0xFFFFFFFF) >> 16
        cand = table[h]
        table[h] = i
        if cand >= 0 and i - cand <= 0xFFFF and data[cand : cand + 4] == data[i : i + 4]:
            ln = 4
            while i + ln < n and ln < 131 and data[cand + ln] == data[i + ln]:
                ln += 1
            flush(i)
            off = i - cand
            out += bytes((0x80 | (ln - 4), off & 0xFF, off >> 8))
            i += ln
            lit_start = i
        else:
            i += 1
    flush(n)
    return bytes(out)


def lz_decompress(data: bytes, expected_len: int) -> bytes:
    if not data:
        return b""
    if (lib := _active()) is not None:
        inp = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(expected_len, dtype=np.uint8)
        ln = lib.tt_lz_decompress(
            _ptr(inp, ctypes.c_uint8), len(data), _ptr(out, ctypes.c_uint8),
            expected_len,
        )
        if ln < 0:
            raise ValueError("corrupt compressed page")
        return out[:ln].tobytes()
    out = bytearray()
    ip, n = 0, len(data)
    while ip < n:
        tok = data[ip]
        ip += 1
        if tok & 0x80:
            ln = (tok & 0x7F) + 4
            if ip + 2 > n or len(out) + ln > expected_len:
                raise ValueError("corrupt compressed page")
            off = data[ip] | (data[ip + 1] << 8)
            ip += 2
            if off == 0 or off > len(out):
                raise ValueError("corrupt compressed page")
            for _ in range(ln):  # the copy may overlap its own output
                out.append(out[-off])
        else:
            ln = tok + 1
            if ip + ln > n or len(out) + ln > expected_len:
                raise ValueError("corrupt compressed page")
            out += data[ip : ip + ln]
            ip += ln
    return bytes(out)


def orc_rle2(data: bytes, count: int, signed: bool) -> Optional[np.ndarray]:
    """ORC RLEv2 integer decode (None -> caller uses the Python path)."""
    lib = _active()
    if lib is None or count == 0:
        return None if lib is None else np.zeros(0, dtype=np.int64)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(count, dtype=np.int64)
    rc = lib.tt_orc_rle2(
        _ptr(buf, ctypes.c_uint8), len(buf), count, int(signed),
        _ptr(out, ctypes.c_int64),
    )
    if rc < 0:
        raise ValueError("corrupt ORC RLEv2 stream")
    return out


def orc_rle1(data: bytes, count: int, signed: bool) -> Optional[np.ndarray]:
    lib = _active()
    if lib is None or count == 0:
        return None if lib is None else np.zeros(0, dtype=np.int64)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(count, dtype=np.int64)
    rc = lib.tt_orc_rle1(
        _ptr(buf, ctypes.c_uint8), len(buf), count, int(signed),
        _ptr(out, ctypes.c_int64),
    )
    if rc < 0:
        raise ValueError("corrupt ORC RLEv1 stream")
    return out


def orc_byte_rle(data: bytes, count: int) -> Optional[np.ndarray]:
    lib = _active()
    if lib is None or count == 0:
        return None if lib is None else np.zeros(0, dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(count, dtype=np.uint8)
    rc = lib.tt_orc_byte_rle(
        _ptr(buf, ctypes.c_uint8), len(buf), count, _ptr(out, ctypes.c_uint8)
    )
    if rc < 0:
        raise ValueError("corrupt ORC byte-RLE stream")
    return out


def orc_decimal64(data: bytes, count: int) -> Optional[np.ndarray]:
    lib = _active()
    if lib is None or count == 0:
        return None if lib is None else np.zeros(0, dtype=np.int64)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(count, dtype=np.int64)
    rc = lib.tt_orc_decimal64(
        _ptr(buf, ctypes.c_uint8), len(buf), count, _ptr(out, ctypes.c_int64)
    )
    if rc < 0:
        raise ValueError("corrupt ORC decimal stream")
    return out


def orc_rle2_encode(vals: np.ndarray, signed: bool) -> Optional[bytes]:
    """ORC RLEv2 integer encode (None -> caller uses the Python path)."""
    lib = _active()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    n = len(vals)
    if n == 0:
        return b""
    out = np.empty(9 * n + 64, dtype=np.uint8)
    ln = lib.tt_orc_rle2_encode(
        _ptr(vals, ctypes.c_int64), n, int(signed), _ptr(out, ctypes.c_uint8)
    )
    return out[:ln].tobytes()


def orc_byte_rle_encode(b: np.ndarray) -> Optional[bytes]:
    lib = _active()
    if lib is None:
        return None
    b = np.ascontiguousarray(b, dtype=np.uint8)
    n = len(b)
    if n == 0:
        return b""
    out = np.empty(2 * n + 64, dtype=np.uint8)
    ln = lib.tt_orc_byte_rle_encode(
        _ptr(b, ctypes.c_uint8), n, _ptr(out, ctypes.c_uint8)
    )
    return out[:ln].tobytes()


def arena_words(nbytes_list: Sequence[int]) -> int:
    """uint32 words a staging arena needs for these source byte sizes
    (each source lands word-aligned with zeroed tail padding)."""
    return sum((nb + 3) // 4 for nb in nbytes_list)


def pack_arena(
    arrays: Sequence[np.ndarray], use_native: bool = True
) -> np.ndarray:
    """Copy column buffers into ONE contiguous uint32 staging arena.

    Every buffer (data, validity, selection) lands word-aligned with its
    tail padding zeroed, so the native and NumPy versions are bit-identical
    (the reference's staging layout; the port's one pinned copy a scan
    aligns its segments to 8 bytes through :func:`scatter_segments`).
    """
    srcs = [np.ascontiguousarray(a) for a in arrays]
    sizes = [s.nbytes for s in srcs]
    total = arena_words(sizes)
    out = np.empty(total, dtype=np.uint32)
    if total == 0:
        return out
    if (lib := _active()) is not None and use_native:
        n = len(srcs)
        ptrs = (ctypes.c_void_p * n)(
            *[s.ctypes.data_as(ctypes.c_void_p).value for s in srcs]
        )
        nbytes = np.asarray(sizes, dtype=np.int64)
        rc = lib.tt_pack_arena(
            ptrs,
            _ptr(nbytes, ctypes.c_int64),
            n,
            out.view(np.uint8).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)
            ),
            total,
        )
        if rc != total:
            raise ValueError("arena pack overrun")
        return out
    dst = out.view(np.uint8)
    pos = 0
    for s, nb in zip(srcs, sizes):
        dst[pos : pos + nb] = s.reshape(-1).view(np.uint8)
        padded = (nb + 3) & ~3
        if padded != nb:
            dst[pos + nb : pos + padded] = 0
        pos += padded
    return out


def orc_varint_encode(u: np.ndarray) -> Optional[bytes]:
    """Plain LEB128 of a uint64 array (no delta, unlike varint_encode)."""
    lib = _active()
    if lib is None:
        return None
    u = np.ascontiguousarray(u, dtype=np.uint64)
    n = len(u)
    if n == 0:
        return b""
    out = np.empty(10 * n + 16, dtype=np.uint8)
    ln = lib.tt_orc_varint_encode(
        _ptr(u, ctypes.c_uint64), n, _ptr(out, ctypes.c_uint8)
    )
    return out[:ln].tobytes()


def scatter_segments(
    arrays: Sequence[np.ndarray], offsets: Sequence[int], dst: int, dst_bytes: int
) -> None:
    """Copy ``arrays[i]`` to byte ``offsets[i]`` of the buffer at address
    ``dst`` (``dst_bytes`` long) and zero every gap: the fill of one
    coalesced host-to-device copy (``ingest.py``). Native mode makes one C
    call; NumPy mode copies through a view of the buffer."""
    srcs = [np.ascontiguousarray(a) for a in arrays]
    sizes = [s.nbytes for s in srcs]
    if any(o + nb > dst_bytes for o, nb in zip(offsets, sizes)):
        raise ValueError("segment overruns the staging buffer")
    if (lib := _active()) is not None:
        n = len(srcs)
        ptrs = (ctypes.c_void_p * n)(
            *[s.ctypes.data_as(ctypes.c_void_p).value for s in srcs]
        )
        nbytes = np.asarray(sizes, dtype=np.int64)
        offs = np.asarray(offsets, dtype=np.int64)
        rc = lib.tt_scatter_segments(
            ptrs, _ptr(nbytes, ctypes.c_int64), _ptr(offs, ctypes.c_int64), n,
            ctypes.cast(ctypes.c_void_p(dst), ctypes.POINTER(ctypes.c_uint8)),
            dst_bytes,
        )
        if rc != dst_bytes:
            raise ValueError("staging segments overlap or overrun")
        return
    view = np.ctypeslib.as_array(
        ctypes.cast(ctypes.c_void_p(dst), ctypes.POINTER(ctypes.c_uint8)),
        shape=(dst_bytes,),
    ) if dst_bytes else np.zeros(0, np.uint8)
    pos = 0
    for s, off, nb in zip(srcs, offsets, sizes):
        if off < pos:
            raise ValueError("staging segments overlap or overrun")
        view[pos:off] = 0
        view[off : off + nb] = s.reshape(-1).view(np.uint8)
        pos = off + nb
    view[pos:] = 0
