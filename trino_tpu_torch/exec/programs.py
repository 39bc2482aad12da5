"""What a program is on the card: one CUDA graph of a fragment's, or a
fused unit's, device work at its settled capacities.

The reference compiles each fragment (or fused chain of fragments) into
one XLA executable and keeps it across queries under the canonical plan
fingerprint (``trino_tpu/exec/fragments.py:593-623``). The counterpart
here is a ``torch.cuda.CUDAGraph``: the unit's function runs eagerly
under the capacity retry ladder (``exec/fragments.py::_retry_traced``),
and the run that succeeds is the warm-up of a capture on a side stream.
Later runs of the same program replay the graph:

- **inputs**: scan inputs are read in place from the device table cache
  (their storage identity is part of the program key, so a reloaded
  table is captured again); the parameter tensor and the inputs that
  come from outside the unit are copied into the graph's static buffers
  before each replay;
- **outputs and flags**: the outputs are cloned after each replay; every
  overflow flag, match count and operator counter of the unit rides one
  int64 tensor, read in one host read after the replay (the reference's
  one dispatch round trip);
- **constants**: a host-to-device copy made inside the unit's function
  (a dictionary's truth table, a lookup table) is recorded on the
  warm-up and served from a device copy during the capture, which the
  graph clones on each replay: such structure is fixed at capture and
  valid for the data versions of the program-cache entry that holds the
  program;
- **memory**: graphs allocate from private pools (:class:`ProgramPool`),
  each shared by the programs captured into it one after the other, on
  one capture stream, so a capture reuses the scratch that the pool's
  earlier captures freed and cached graphs do not each keep their
  intermediates. Graphs are replayed one at a time and their outputs
  cloned at once, so a graph may reuse what another freed. A pool's
  segments return to the card only once no graph holds them, so pools
  come in generations: captures go into the newest until its graphs'
  live outputs pass half the budget. The budget is a bound: before a
  capture, and again after it, the graphs of the least recently used
  programs go while the generations hold more than the budget (a
  generation left with no graph is released; a generation that alone
  passes it loses every graph). A program whose graph went stays stored
  and runs as a function on its later hits, until a hit finds room under
  the budget for what its capture took: that hit captures it again.

On the CPU there is no graph: the same prepared program runs eagerly on
each hit and counts traces and hits exactly as on the card. A CPU
rehearsal (:attr:`ProgramPool.rehearse`) runs the capture's pass under
:class:`HostReadGuard`, which raises where a capture on the card would
fail (a host read, a data-dependent shape). On the card a capture error
is raised; it never gives way to an eager run.

:func:`checked_syncs` checks a whole run: every synchronization inside it
raises (on the card ``torch.cuda.set_sync_debug_mode("error")``, on the
CPU :class:`HostReadGuard`), except the counted host reads, which lift
the check (:func:`allow_sync`).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Optional

import torch
from torch.overrides import TorchFunctionMode

from trino_tpu_torch.columnar import Batch, Column


# set while a program's function runs, to the list of its deferred
# errors: operators that would pick a path by a host read of the data
# take their data-independent path instead, and a data-dependent error
# (an integer overflow) becomes a flag read with the program's words
_STATIC = contextvars.ContextVar("static_shapes", default=None)
# set inside a counted host read: a run checked by checked_syncs may
# synchronize there
_SYNC_ALLOWED = contextvars.ContextVar("sync_allowed", default=False)


def static_shapes() -> bool:
    """Is a program's function running (no host reads allowed)?"""
    return _STATIC.get() is not None


def defer_error(message: str, flag: torch.Tensor) -> bool:
    """Inside a program: record ``flag`` (true where the data makes
    ``message`` an error) for the program's one host read, which raises
    it; returns False outside a program, where the caller raises at
    once."""
    errors = _STATIC.get()
    if errors is None:
        return False
    errors.append((f"err!{message}", flag))
    return True


def take_deferred_errors() -> list:
    """The deferred errors of the running program function, cleared."""
    errors = _STATIC.get() or []
    out = list(errors)
    errors.clear()
    return out


@contextlib.contextmanager
def program_run():
    """The scope of a program's function: :func:`static_shapes` is true."""
    token = _STATIC.set([])
    try:
        yield
    finally:
        _STATIC.reset(token)


class CaptureError(RuntimeError):
    """A unit's device work could not be captured as one program: it
    reads the device from the host, or shapes a tensor by its data."""


class NotCapturable(CaptureError):
    """Raised inside a program's function by an operator that knows it
    needs the host (a per-row string materialization): the fragment then
    runs eagerly, and the executor counts it."""


@contextlib.contextmanager
def allow_sync(device=None):
    """A counted host read: lift the check of :func:`checked_syncs` for
    its duration, so that a checked run fails on every other
    synchronization only."""
    token = _SYNC_ALLOWED.set(True)
    mode = 0
    if device is not None and torch.device(device).type == "cuda":
        mode = torch.cuda.get_sync_debug_mode()
        if mode:
            torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)
        _SYNC_ALLOWED.reset(token)


@contextlib.contextmanager
def checked_syncs(device):
    """Every synchronization inside raises, but those of the counted host
    reads (:func:`allow_sync`): on the card under
    ``torch.cuda.set_sync_debug_mode("error")``, on the CPU under
    :class:`HostReadGuard` (which cannot tell a host tensor from a device
    one there, so it is the stricter of the two)."""
    token = _SYNC_ALLOWED.set(False)
    try:
        if torch.device(device).type == "cuda":
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        else:
            with HostReadGuard(lifted_by_allow_sync=True):
                yield
    finally:
        _SYNC_ALLOWED.reset(token)


def host_read(tensor: torch.Tensor, stats: Optional[dict] = None) -> list:
    """One counted device-to-host read of ``tensor`` as a Python list;
    ``stats["host_reads"]`` counts it."""
    if stats is not None:
        stats["host_reads"] = stats.get("host_reads", 0) + 1
    with allow_sync(tensor.device):
        return tensor.cpu().tolist()


# torch functions that read the device from the host or shape their
# output by the data: each synchronizes a CUDA stream, which a capture
# forbids
_T = torch.Tensor
_HOST_READS = {
    _T.item, _T.tolist, _T.cpu, _T.numpy, _T.__bool__, _T.__int__,
    _T.__float__, _T.__index__, _T.nonzero, _T.unique,
    _T.unique_consecutive, _T.masked_select, _T.argwhere, _T.bincount,
    torch.nonzero, torch.unique, torch.unique_consecutive,
    torch.masked_select, torch.argwhere, torch.bincount,
}


def _is_host(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type == "cpu"


# factories that read a tensor argument (a size, a bound, a fill value)
# on the host
_FACTORIES = {torch.full, torch.arange, torch.zeros, torch.ones, torch.empty}


def _bool_index(idx) -> bool:
    """A boolean mask, or a 0-d integer tensor (torch reads it on the
    host as a Python index), in an index expression."""
    if isinstance(idx, torch.Tensor):
        return idx.dtype == torch.bool or idx.ndim == 0
    if isinstance(idx, tuple):
        return any(_bool_index(i) for i in idx)
    return False


class HostReadGuard(TorchFunctionMode):
    """Raises :class:`CaptureError` on every torch call that would
    synchronize a CUDA stream: ``item``/``tolist``/``cpu``, a tensor's
    truth value, ``nonzero``, ``unique``, boolean-mask indexing,
    ``repeat_interleave`` without ``output_size``, ``torch.where`` with
    one argument. The CPU's stand-in for a capture's refusals; with
    ``lifted_by_allow_sync`` (:func:`checked_syncs`) the counted reads
    inside :func:`allow_sync` pass."""

    def __init__(self, lifted_by_allow_sync: bool = False):
        super().__init__()
        self.lifted = lifted_by_allow_sync

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.lifted and _SYNC_ALLOWED.get():
            return func(*args, **kwargs)
        bad = None
        if func in _HOST_READS:
            bad = getattr(func, "__name__", str(func))
        elif func in (_T.__getitem__, _T.__setitem__) and len(args) > 1 and _bool_index(args[1]):
            bad = "indexing by a boolean mask or a 0-d tensor"
        elif func in (torch.repeat_interleave, _T.repeat_interleave) and (
            "output_size" not in kwargs and isinstance(args[1] if len(args) > 1 else kwargs.get("repeats"), torch.Tensor)
        ):
            bad = "repeat_interleave without output_size"
        elif func is torch.where and len(args) == 1 and not kwargs:
            bad = "torch.where(condition)"
        elif func in _FACTORIES and any(
            isinstance(a, torch.Tensor)
            or (isinstance(a, (tuple, list)) and any(isinstance(b, torch.Tensor) for b in a))
            for a in args
        ):
            bad = f"{func.__name__} with a tensor argument"
        if bad is not None:
            raise CaptureError(f"host read inside a program: {bad}")
        return func(*args, **kwargs)


_H2D_FUNCS = {torch.tensor, torch.as_tensor}


def _h2d_call(func, args, kwargs) -> bool:
    """Is this call a host-to-device copy (a CPU source, a CUDA result)?"""
    if func in _H2D_FUNCS:
        dev = kwargs.get("device")
        if args and isinstance(args[0], torch.Tensor) and args[0].device.type == "cuda":
            return False  # already on the card: no copy from the host
        return dev is not None and torch.device(dev).type == "cuda"
    if func is _T.to and args and _is_host(args[0]):
        for a in list(args[1:]) + list(kwargs.values()):
            if isinstance(a, (str, torch.device)) and torch.device(a).type == "cuda":
                return True
            if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                return True
    if func is _T.cuda and args and _is_host(args[0]):
        return True
    if func is _T.new_tensor and args and args[0].device.type == "cuda":
        return True
    return False


def _scalar_store(func, args) -> bool:
    """``cuda_tensor[index] = python_number``: torch copies the number
    from the host, which a capture forbids."""
    return (
        func is _T.__setitem__ and len(args) == 3
        and isinstance(args[0], torch.Tensor) and args[0].device.type == "cuda"
        and isinstance(args[2], (bool, int, float))
    )


def _host_source(func, args, kwargs) -> torch.Tensor:
    """The host data of a host-to-device copy, as a CPU tensor."""
    if func in _H2D_FUNCS:
        return torch.as_tensor(args[0], dtype=kwargs.get("dtype"))
    if func is _T.new_tensor:
        return torch.as_tensor(args[1], dtype=kwargs.get("dtype", args[0].dtype))
    return args[0]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    eq = a == b
    if a.is_floating_point():
        eq = eq | (a.isnan() & b.isnan())
    return bool(eq.all())


class ConstantRecorder(TorchFunctionMode):
    """Records the host-to-device copies of a unit's eager warm-up, in
    order (``record``), and serves them during the capture (``serve``): a
    copy from pageable host memory synchronizes, which a capture
    forbids. The capture's copy must carry the same host data as the
    warm-up's in the same place of the sequence, else it raises. A
    served constant is cloned on the device, so a replay starts from the
    warm-up's value whatever the unit writes into it; the graph reads
    the recorded tensors at every replay, so the program keeps them
    (:func:`capture`). A Python number stored into a CUDA tensor is
    filled on the device first, in both passes."""

    def __init__(self):
        super().__init__()
        # (host data, device copy) of each host-to-device copy, in order
        self.recorded: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._serving: Optional[list] = None

    def record(self):
        self.recorded = []
        self._serving = None
        return self

    def serve(self):
        self._serving = list(self.recorded)
        return self

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _scalar_store(func, args):
            # the number filled on the device, then stored from there
            value = torch.full((), args[2], dtype=args[0].dtype, device=args[0].device)
            return func(args[0], args[1], value)
        if not _h2d_call(func, args, kwargs):
            return func(*args, **kwargs)
        host = _host_source(func, args, kwargs)
        if self._serving is None:
            out = func(*args, **kwargs)
            self.recorded.append((host.clone(), out.clone()))
            return out
        if not self._serving:
            raise CaptureError("a host-to-device copy the warm-up did not make")
        want, const = self._serving.pop(0)
        if not _same(host, want):
            raise CaptureError("a host-to-device copy differs from the warm-up's")
        return const.clone()


def _tensors_of(batch: Batch) -> list:
    out = []
    for c in batch.columns:
        out.append(c.data)
        if c.valid is not None:
            out.append(c.valid)
    if batch.sel is not None:
        out.append(batch.sel)
    return out


# content keys of dictionaries made anew by each run (an eager fragment's
# string expression), by object; weak, so a dead dictionary's entry goes
_DICT_KEYS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _dict_key(d, in_place: bool):
    """A dictionary's part of a program key: a cached table's by identity;
    a copied input's by content, since a fragment that runs eagerly makes
    an equal dictionary anew every run (its values are fixed in the
    captured program's string tables)."""
    if d is None:
        return None
    if in_place:
        return id(d)
    key = _DICT_KEYS.get(d)
    if key is None or key[0] != len(d.values):
        key = (len(d.values), hash(tuple(d.values)))
        _DICT_KEYS[d] = key
    return key


def batch_signature(batch: Batch, in_place: bool) -> tuple:
    """What a captured program assumed of one input batch: per column its
    shape, dtype, whether it has a validity mask and its dictionary; the
    selection's presence and the row count. ``in_place`` inputs (scans
    read from the device table cache) add their storage addresses."""
    cols = tuple(
        (
            tuple(c.data.shape), str(c.data.dtype), c.valid is not None,
            _dict_key(c.dictionary, in_place),
            (c.data.data_ptr(), None if c.valid is None else c.valid.data_ptr())
            if in_place else None,
        )
        for c in batch.columns
    )
    sel = None
    if batch.sel is not None:
        sel = (tuple(batch.sel.shape), batch.sel.data_ptr() if in_place else None)
    return cols, sel, batch.num_rows


def _static_copy(value):
    """A static buffer shaped like one copied input."""
    if isinstance(value, torch.Tensor):
        return value.clone()
    return Batch(
        [Column(c.type, c.data.clone(), None if c.valid is None else c.valid.clone(),
                c.dictionary) for c in value.columns],
        value.num_rows,
        None if value.sel is None else value.sel.clone(),
        value.device,
        value.shards,
    )


def _copy_into(static, value) -> None:
    if isinstance(static, torch.Tensor):
        static.copy_(value, non_blocking=True)
        return
    for dst, src in zip(_tensors_of(static), _tensors_of(value)):
        dst.copy_(src, non_blocking=True)


class Program:
    """One stored program: the unit's function ``fn(inputs) -> (result,
    words)``, where ``words`` is the one int64 tensor of its flags, match
    counts and counters; its metadata (``meta``: output layout, column
    types and dictionaries, the names of the words); and on the card its
    graph, static input buffers and static outputs."""

    def __init__(self, key, label: str, fn: Callable, meta: Any):
        self.key = key
        self.label = label
        # the inputs' names at capture; a later run's inputs map onto
        # them by position
        self.input_keys: list[str] = []
        self.fn = fn
        self.meta = meta
        self.graph = None
        # copied inputs' static buffers, and the in-place inputs (kept
        # alive: the graph reads their storage)
        self.static_inputs: dict[str, Any] = {}
        self.constants: list = []  # the warm-up's host-to-device copies
        self.static_result = None
        self.static_words: Optional[torch.Tensor] = None
        self.launches: dict[str, int] = {}
        self.capture_ms = 0.0
        self.pool_bytes: Optional[int] = None
        # bytes the program keeps on the card between replays: its static
        # inputs, outputs and words, and the recorded constants
        self.held_bytes = 0
        self.generation: Optional[dict] = None  # the pool generation of its graph
        # what its last capture added to the generations' segments: a
        # program whose graph went is captured again on a hit that finds
        # this much room under the budget
        self.capture_bytes: Optional[int] = None
        # the allocator's stats of its capture (obs/profiler.py), None
        # unless device_profiling was on when it was captured
        self.device_stats: Optional[dict] = None


class ProgramPool:
    """The engine's programs' graph memory, the LRU order of every stored
    program (evictions take the least recently used first) and the
    capture and eviction counters that ``system.runtime.programs`` and
    the chip checks show.

    Graphs share their memory in generations: each generation is one
    private pool, captured into (on one stream, so that captures reuse
    each other's scratch) until its graphs' live outputs pass half the
    budget, then closed to new captures. A pool's segments return to the
    card only once no graph holds them, so before each capture and after
    it, while all the generations together hold more than the budget,
    the graphs of the least recently used programs go (``dropped``); a
    generation left with none is released. The newest capture's graph
    goes last, or with its generation's when that alone passes the
    budget. The programs stay stored and run as functions on later hits
    (``eager_hits``) until one finds room for their capture
    (``recaptures``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        # oldest first: {"handle": pool handle, "programs": ids, "open": bool}
        self._gens: list[dict] = []
        self._released = False  # a generation emptied since empty_cache
        # the bound of all generations' segments (an eighth of the card:
        # with the table cache's quarter, the working set of a query
        # keeps more than half the card)
        self.budget_bytes = (
            torch.cuda.get_device_properties(self.device).total_memory // 8
            if self.device.type == "cuda" else None
        )
        self._lru: "OrderedDict[int, tuple[dict, Any]]" = OrderedDict()
        # CPU rehearsal of each capture under HostReadGuard (tests)
        self.rehearse = False
        self.captures = 0
        self.recaptures = 0  # captures of programs whose graph had gone
        self.evicted = 0  # programs dropped by evictions
        self.dropped = 0  # graphs dropped to hold the budget (programs kept)
        self.eager_hits = 0  # hits of a program with no graph, run as functions
        # every capture runs on this one stream: the allocator gives a
        # freed block of a pool only to the stream that allocated it, so
        # a capture reuses what the generation's earlier captures freed
        self._stream = None
        # the allocator's segments, one dict a segment (a CPU test gives
        # its own)
        self.snapshot = torch.cuda.memory_snapshot if self.on_card else None
        # held by the profiler's peak window (obs/profiler.py) over one
        # program's warm-up and capture: the allocator's peak is
        # process-wide, so one window at a time resets it
        self.profile_lock = threading.Lock()

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def generation(self) -> dict:
        """The generation a new capture goes into: the newest while it is
        open, else a new one."""
        if not self._gens or not self._gens[-1]["open"]:
            self._gens.append({"handle": torch.cuda.graph_pool_handle(),
                               "programs": set(), "open": True})
        return self._gens[-1]

    def touch(self, store: dict, key) -> None:
        self._lru[id(store[key])] = (store, key)
        self._lru.move_to_end(id(store[key]))

    def forget(self, program: Program) -> None:
        self._lru.pop(id(program), None)
        gen = program.generation
        if gen is not None:
            gen["programs"].discard(id(program))
            if not gen["programs"] and gen in self._gens:
                # no capture goes into it again: its segments are freed
                # once its last graph is
                self._gens.remove(gen)
                self._released = True

    def held_bytes(self) -> int:
        """Bytes the stored programs keep between replays."""
        return sum(
            getattr(store.get(key), "held_bytes", 0) for store, key in self._lru.values()
        )

    def _evict_one(self) -> int:
        _, (store, key) = self._lru.popitem(last=False)
        prog = store.pop(key, None)
        if prog is not None:
            self.forget(prog)
        self.evicted += 1
        return getattr(prog, "held_bytes", 0)

    def _release(self) -> None:
        if self._released and self.on_card:
            torch.cuda.empty_cache()
        self._released = False

    def evict_lru(self, target_bytes: int = 0) -> int:
        """Drop the least recently used programs from their stores until
        those left hold at most ``target_bytes`` (0: every program);
        returns how many went. Generations left with no program are
        released."""
        dropped = 0
        held = self.held_bytes()
        while self._lru and (held > target_bytes or target_bytes <= 0):
            held -= self._evict_one()
            dropped += 1
        self._release()
        return dropped

    def make_room(self) -> None:
        """Before a capture: close the newest generation once its graphs'
        live blocks (their outputs) pass half the budget, then hold the
        budget (:meth:`_fit_budget`). The rest of a generation's segments
        is the scratch its captures freed, which the next capture into it
        reuses: a generation is not closed for that."""
        segs = self._segments_by_generation()
        if segs is None:
            return
        if self._gens and segs.get(id(self._gens[-1]), (0, 0))[1] > self.budget_bytes // 2:
            self._gens[-1]["open"] = False
        self._fit_budget({g: total for g, (total, _) in segs.items()})

    def settle(self, program: Program) -> None:
        """After ``program``'s capture: when its generation alone holds
        more than the budget, every graph of the generation goes, its own
        too, and the generation's bytes become ``program``'s capture size
        (so it is not captured again until that much fits); then
        :meth:`_fit_budget`, ``program``'s graph kept."""
        by_gen = self._reserved_by_generation()
        if by_gen is None:
            return
        gen = program.generation
        if gen is not None and by_gen.get(id(gen), 0) > self.budget_bytes:
            program.capture_bytes = max(program.capture_bytes or 0, by_gen[id(gen)])
            for other in self._holders(lambda p: p.generation is gen and p is not program):
                self._drop_graph(other)
            self._drop_graph(program)
            self._release()
            by_gen = self._reserved_by_generation()
        self._fit_budget(by_gen, keep=program)
        by_gen = self._reserved_by_generation()
        program.pool_bytes = sum(by_gen.values()) if by_gen else 0

    def _holders(self, want) -> list:
        """Stored programs holding a graph that ``want`` takes, least
        recently used first."""
        out = []
        for store, key in self._lru.values():
            prog = store.get(key)
            if prog is not None and prog.generation is not None and want(prog):
                out.append(prog)
        return out

    def _fit_budget(self, by_gen: dict, keep: Optional[Program] = None) -> None:
        """While the generations hold more than the budget, the graphs of
        the least recently used programs go (a graph-less program holds
        no segment and is passed by; ``keep``'s graph stays)."""
        def total() -> int:
            return sum(by_gen.get(id(g), 0) for g in self._gens)

        while total() > self.budget_bytes:
            victims = self._holders(lambda p: p is not keep)
            if not victims:
                break
            self._drop_graph(victims[0])
        self._release()

    def _drop_graph(self, program: Program) -> None:
        """Release ``program``'s graph, outputs and buffers; the program
        stays stored and runs as a function on its later hits until one
        finds room to capture it again (:meth:`may_recapture`). Its
        generation, left with no graph, is released."""
        gen = program.generation
        program.graph = program.generation = None
        program.static_inputs, program.constants = {}, []
        program.static_result = program.static_words = None
        program.held_bytes = 0
        if gen is not None:
            gen["programs"].discard(id(program))
            if not gen["programs"] and gen in self._gens:
                self._gens.remove(gen)
                self._released = True
        self.dropped += 1

    def _segments_by_generation(self) -> Optional[dict]:
        """``{id(generation): (segment bytes, live block bytes)}``, or None
        where the allocator gives no snapshot."""
        if self.snapshot is None:
            return None
        try:
            segs = self.snapshot()
        except Exception:  # noqa: BLE001 — allocator without snapshots
            return None
        pools = {tuple(g["handle"]): id(g) for g in self._gens}
        out = {id(g): (0, 0) for g in self._gens}
        for seg in segs:
            gen = pools.get(tuple(seg.get("segment_pool_id", ())))
            if gen is not None:
                total, active = out[gen]
                out[gen] = (total + int(seg.get("total_size", 0)),
                            active + int(seg.get("active_size", 0)))
        return out

    def _reserved_by_generation(self) -> Optional[dict]:
        segs = self._segments_by_generation()
        return None if segs is None else {g: total for g, (total, _) in segs.items()}

    def may_recapture(self, program: Program) -> bool:
        """Is ``program``'s graph gone, and does its last capture's growth
        fit under the budget beside the generations' segments now?"""
        if program.graph is not None or program.capture_bytes is None:
            return False
        by_gen = self._reserved_by_generation()
        return by_gen is not None and (
            sum(by_gen.values()) + program.capture_bytes <= self.budget_bytes)

    def reserved_bytes(self) -> Optional[int]:
        """Bytes the generations' segments hold on the card, or None."""
        by_gen = self._reserved_by_generation()
        return None if by_gen is None or not self._gens else sum(by_gen.values())


def _held_bytes(program: Program, copied: set) -> int:
    """Bytes a captured program keeps: its static outputs and words, the
    static buffers of its copied inputs and its recorded constants (the
    in-place inputs belong to the table cache)."""
    tensors = _tensors_of(program.static_result.batch) + [program.static_words]
    tensors += program.constants
    for k in copied:
        v = program.static_inputs[k]
        tensors += [v] if isinstance(v, torch.Tensor) else _tensors_of(v)
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total


def capture(pool: ProgramPool, program: Program, inputs: dict, copied: set,
            recorder: ConstantRecorder) -> None:
    """Capture ``program.fn`` over ``inputs`` into a CUDA graph from the
    pool: the keys in ``copied`` get static buffers, the others are read
    in place and kept alive by the program. On the CPU with
    ``pool.rehearse`` the pass runs under :class:`HostReadGuard`; on the
    CPU otherwise nothing is captured."""
    from trino_tpu_torch import _kernels

    program.static_inputs = {
        k: (_static_copy(v) if k in copied else v) for k, v in inputs.items()
    }
    if not pool.on_card:
        if pool.rehearse:
            with HostReadGuard(), program_run():
                program.fn(program.static_inputs)
        program.static_inputs = {}
        return
    t0 = time.perf_counter()
    recapture = program.capture_bytes is not None
    pool.make_room()
    gen = pool.generation()
    dev = pool.device
    reserved_before = pool.reserved_bytes() or 0
    before = dict(_kernels.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    side = pool.stream()
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        graph.capture_begin(pool=gen["handle"])
        try:
            with recorder.serve(), program_run():
                result, words = program.fn(program.static_inputs)
        except BaseException:
            try:
                graph.capture_end()
            except Exception:  # noqa: BLE001 — the capture is already broken
                pass
            if not gen["programs"]:
                # a pool no graph holds is never captured into again
                pool._gens.remove(gen)
                pool._released = True
            raise
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    program.launches = {
        k: v - before.get(k, 0) for k, v in _kernels.LAUNCHES.items()
        if v != before.get(k, 0)
    }
    # the capture launched nothing: its kernel counts are the replays'
    for k, n in program.launches.items():
        _kernels.LAUNCHES[k] -= n
    program.graph = graph
    program.generation = gen
    gen["programs"].add(id(program))
    # the recorded constants are the sources of the graph's clones
    program.constants = [dev for _, dev in recorder.recorded]
    program.static_result = result
    program.static_words = words
    program.held_bytes = _held_bytes(program, copied)
    program.capture_bytes = max(0, (pool.reserved_bytes() or 0) - reserved_before)
    pool.captures += 1
    pool.recaptures += recapture
    # the program holds the graph and its outputs alone: a graph that
    # settle drops frees its pool's segments at once
    del graph, result, words
    pool.settle(program)
    program.capture_ms = (time.perf_counter() - t0) * 1000.0


def replay(pool: ProgramPool, program: Program, inputs: dict, copied: set):
    """Run a stored program on new inputs: the graph's replay on the card
    (copied inputs into their buffers first, outputs cloned after), the
    function itself on the CPU. Returns ``(result, words)``."""
    from trino_tpu_torch import _kernels

    if program.graph is None or pool is None:
        if pool is not None and pool.on_card:
            pool.eager_hits += 1
        with program_run():
            return program.fn(inputs)
    for k in copied:
        _copy_into(program.static_inputs[k], inputs[k])
    program.graph.replay()
    res = program.static_result
    b = res.batch
    cols = [
        Column(c.type, c.data.clone(), None if c.valid is None else c.valid.clone(),
               c.dictionary)
        for c in b.columns
    ]
    out = type(res)(
        Batch(cols, b.num_rows, None if b.sel is None else b.sel.clone(), b.device, b.shards),
        dict(res.layout),
    )
    # a probe exchange's hot-key set rides its result (exec/fragments.py)
    aux = getattr(res, "aux", ())
    if aux:
        out.aux = tuple(t.clone() for t in aux)
    words = program.static_words.clone()
    _kernels.count_replay(program.launches)
    return out, words
