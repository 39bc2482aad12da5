"""Device-level program profiling from the CUDA caching allocator.

Counterpart of ``trino_tpu/obs/profiler.py``. The reference reads XLA's
cost and memory analyses of each program it compiles ahead of time. This
package compiles nothing and has no cost model: a program here is one
CUDA graph of a fragment's or fused unit's device work
(``exec/programs.py``), and what the card reports of it comes from the
caching allocator. So these are allocator numbers, not a cost model:

- ``argument_bytes``: the bytes of the tensors the captured graph reads
  as inputs (static input buffers and in-place scan columns, each
  storage once);
- ``output_bytes``: the bytes of its static outputs and its words;
- ``temp_bytes``: its ``capture_bytes``, what its capture added to the
  graph pools' segments;
- ``peak_hbm_bytes``: the allocator's peak over the program's warm-up
  and capture above what was allocated before them, plus its arguments
  (:class:`PeakWindow`, taken under the pool's lock so that no other
  capture resets the peak meanwhile); where the window could not be
  taken, the conservative sum of the three above, as the reference
  computes it when its backend has no peak. Never below
  ``argument_bytes + output_bytes``, which the program holds at once.

``flops`` and ``bytes_accessed`` stay absent, as on a reference backend
that reports none; every key is optional. On the CPU nothing is
captured, so a program's entry carries ``executions`` and
``compile_ms`` only (the reference's degraded mode). Profiling never
fails a query: every reader here returns None on an error.

The allocator's peak is process-wide. :func:`reset_allocator_peak` and
:func:`allocator_peak` are the peak a caller outside the engine reads
over a span of work: a window's reset inside that span does not lower
it.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Optional

import torch


def _finite(v: Any) -> Optional[float]:
    """Numeric, finite and non-negative (the reference's filter)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    f = float(v)
    if not math.isfinite(f) or f < 0:
        return None
    return f


# per device index: the highest allocator peak a window reset away since
# the last reset_allocator_peak
_PEAK_FLOOR: dict[int, int] = {}
_PEAK_LOCK = threading.Lock()


def _index(device) -> int:
    d = torch.device(device)
    return d.index if d.index is not None else torch.cuda.current_device()


def reset_allocator_peak(device="cuda") -> None:
    """Start a span of work whose allocator peak :func:`allocator_peak`
    reads (``torch.cuda.reset_peak_memory_stats``, and the floor the
    windows keep)."""
    with _PEAK_LOCK:
        torch.cuda.reset_peak_memory_stats(device)
        _PEAK_FLOOR[_index(device)] = 0


def allocator_peak(device="cuda") -> int:
    """The allocator's peak since :func:`reset_allocator_peak`, a
    profiling window's reset inside the span included."""
    with _PEAK_LOCK:
        return max(torch.cuda.max_memory_allocated(device),
                   _PEAK_FLOOR.get(_index(device), 0))


class PeakWindow:
    """The allocator's peak over one program's warm-up and capture.

    Entered only when the pool's ``profile_lock`` is free (no other
    query's window runs): it keeps the process peak so far as the floor
    of :func:`allocator_peak`, resets the peak, and on exit holds in
    :attr:`peak` the peak above the bytes allocated at entry. A window
    that found the lock taken, or a pool off the card, measures nothing
    (``peak`` stays None)."""

    def __init__(self, pool, enabled: bool = True):
        self.pool = pool
        self.enabled = bool(enabled and pool is not None and pool.on_card)
        self.peak: Optional[int] = None
        self._held = False
        self._base = 0

    def __enter__(self):
        if not self.enabled or not self.pool.profile_lock.acquire(blocking=False):
            return self
        self._held = True
        try:
            dev = self.pool.device
            with _PEAK_LOCK:
                idx = _index(dev)
                _PEAK_FLOOR[idx] = max(_PEAK_FLOOR.get(idx, 0),
                                       torch.cuda.max_memory_allocated(dev))
                torch.cuda.reset_peak_memory_stats(dev)
            self._base = torch.cuda.memory_allocated(dev)
        except Exception:  # noqa: BLE001 — profiling never fails a query
            self.pool.profile_lock.release()
            self._held = False
        return self

    def __exit__(self, *exc):
        if not self._held:
            return False
        try:
            if exc[0] is None:
                self.peak = max(
                    0, torch.cuda.max_memory_allocated(self.pool.device) - self._base)
        except Exception:  # noqa: BLE001
            self.peak = None
        finally:
            self.pool.profile_lock.release()
            self._held = False
        return False


def _storage_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


def _batch_tensors(value) -> list:
    if isinstance(value, torch.Tensor):
        return [value]
    out = []
    for c in getattr(value, "columns", ()):
        out.append(c.data)
        if c.valid is not None:
            out.append(c.valid)
    if getattr(value, "sel", None) is not None:
        out.append(value.sel)
    return out


def capture_device_stats(program, window_peak: Optional[int] = None) -> Optional[dict]:
    """What the allocator reports of a captured ``program``
    (``exec/programs.py::Program``): ``argument_bytes``,
    ``output_bytes``, ``temp_bytes`` and ``peak_hbm_bytes``, or None when
    nothing was captured (the CPU, or a graph the pool's budget dropped
    at once). ``window_peak`` is a :class:`PeakWindow`'s reading over the
    program's warm-up and capture."""
    try:
        if getattr(program, "graph", None) is None or program.static_result is None:
            return None
        args = []
        for v in program.static_inputs.values():
            args += _batch_tensors(v)
        outs = _batch_tensors(program.static_result.batch) + [program.static_words]
        out: dict[str, int] = {
            "argument_bytes": _storage_bytes(args),
            "output_bytes": _storage_bytes(outs),
        }
        temp = _finite(program.capture_bytes)
        if temp is not None:
            out["temp_bytes"] = int(temp)
        held = out["argument_bytes"] + out["output_bytes"]
        if window_peak is not None:
            peak = int(window_peak) + out["argument_bytes"]
        else:
            peak = held + out.get("temp_bytes", 0)
        out["peak_hbm_bytes"] = max(peak, held)
        return out
    except Exception:  # noqa: BLE001 — profiling never fails a query
        return None


_WINDOW_LOCKS: dict[str, threading.Lock] = {}


def window_lock(device) -> threading.Lock:
    """The lock of the profiling windows on ``device``: one window at a
    time, the allocator's peak being process-wide (a program pool's
    ``profile_lock`` and :func:`profiled_call` share it)."""
    with _PEAK_LOCK:
        return _WINDOW_LOCKS.setdefault(str(torch.device(device)), threading.Lock())


class _DeviceScope:
    """What :class:`PeakWindow` needs of a pool: the device and its
    windows' lock."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.profile_lock = window_lock(self.device)


def profiled_call(device, fn, *args):
    """Run ``fn(*args)`` (an interpreter step's eager call) and what the
    allocator reports of it: ``(result, stats)``, ``stats`` holding
    ``argument_bytes``, ``output_bytes`` and ``peak_hbm_bytes`` (the
    argument bytes plus the allocator's peak above its bytes at the call)
    on a card, None on the CPU or when another window runs (reference:
    ``trino_tpu/parallel/distributed.py::_profiled_call``, which reads
    XLA's memory analysis of the call's jit; nothing is compiled here).
    Profiling never fails the call."""
    scope = _DeviceScope(device)
    window = PeakWindow(scope)
    with window:
        result = fn(*args)
    if window.peak is None:
        return result, None
    try:
        args_bytes = _storage_bytes(_leaves(args))
        out_bytes = _storage_bytes(_leaves(result))
        return result, {
            "argument_bytes": args_bytes,
            "output_bytes": out_bytes,
            "peak_hbm_bytes": max(int(window.peak) + args_bytes, args_bytes + out_bytes),
        }
    except Exception:  # noqa: BLE001
        return result, None


def _leaves(value) -> list:
    if isinstance(value, (list, tuple)):
        out = []
        for v in value:
            out += _leaves(v)
        return out
    return _batch_tensors(value)


def rollup_device_stats(programs: dict[str, dict]) -> dict:
    """Query-level rollup over per-program stats: summed FLOPs/bytes
    weighted by execution count, peak device bytes as the max across
    programs (programs run one after the other within a query, so
    concurrent residency is bounded by the largest single program)."""
    total_flops = 0.0
    total_bytes = 0.0
    peak = 0
    have_flops = have_bytes = have_peak = False
    for st in programs.values():
        execs = max(1, int(st.get("executions", 1)))
        if "flops" in st:
            have_flops = True
            total_flops += st["flops"] * execs
        if "bytes_accessed" in st:
            have_bytes = True
            total_bytes += st["bytes_accessed"] * execs
        if "peak_hbm_bytes" in st:
            have_peak = True
            peak = max(peak, int(st["peak_hbm_bytes"]))
    out: dict[str, Any] = {"programs_profiled": len(programs)}
    if have_flops:
        out["total_flops"] = total_flops
    if have_bytes:
        out["total_bytes_accessed"] = total_bytes
    if have_peak:
        out["peak_hbm_bytes"] = peak
    return out


def merge_device_stats(target: dict, source: Optional[dict]) -> dict:
    """Merge one executor's ``device_stats_snapshot()['programs']`` into
    an accumulating per-program dict. Program-shape fields overwrite;
    ``executions``/``compile_ms`` accumulate."""
    for label, st in (source or {}).items():
        if not isinstance(st, dict):
            continue
        ent = target.setdefault(label, {"executions": 0, "compile_ms": 0.0})
        ent["executions"] += int(st.get("executions", 1))
        ent["compile_ms"] = round(
            ent["compile_ms"] + float(st.get("compile_ms", 0.0)), 3
        )
        for k, v in st.items():
            if k not in ("executions", "compile_ms"):
                ent[k] = v
    return target
