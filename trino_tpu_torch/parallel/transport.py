"""The data plane of a mesh that spans server processes.

The reference has no counterpart: under ``jax.distributed`` XLA moves a
pjit program's collectives itself (ICI within a host, DCN across hosts).
Here each server process is one rank of a ``torch.distributed`` group
(``parallel/spmd.py::initialize_spmd``), and the transport is chosen by
where the group's ranks run, never by a failure:

- **every rank on the CPU** (:class:`GlooTransport`): gloo runs the
  collectives on the ranks' tensors directly;
- **every rank on one shared card** (:class:`PeerTransport`): NCCL
  refuses two ranks on one device, but processes that share a card can
  read each other's memory. Each rank allocates one exchange arena on
  the card, inside its card share, publishes its CUDA IPC handle once
  through the group's store and maps every peer's arena once. A
  collective writes the rank's send blocks into its own arena and
  synchronizes its stream; after a gloo barrier each rank copies its
  blocks out of the peers' arenas, device to device, synchronizes, and a
  second barrier frees the arenas for reuse. A collective larger than
  the arena goes through it in rounds. No byte goes through the host;
- **ranks on several cards**: refused (ROADMAP item 9c, its several-cards
  part: NCCL, or peer copies across devices).

The small host reductions of the fragment path (flags, match counts,
counters: :meth:`Transport.reduce_host`) go over gloo on host tensors in
both transports. Every collective and barrier runs under the group's
timeout; one that expires raises on every rank with the collective's
name and its sequence number in the group.
"""

from __future__ import annotations

import pickle
import threading
from typing import Optional

import torch

# the several-cards item of the ROADMAP, named where such a group refuses
SEVERAL_CARDS_ITEM = "9c"
# a rank's exchange arena on a shared card: a join's exchange at TPC-H
# SF1 passes through it in a few rounds, and three ranks' arenas take
# 0.2 GB of the card
ARENA_BYTES = 64 << 20


class CollectiveError(RuntimeError):
    """A collective of the SPMD group failed or timed out on this rank."""


class Transport:
    """The collectives one rank of the group takes part in. Every rank
    calls them in the same order; ``seq`` counts them, so an error names
    the collective that failed."""

    kind = "none"

    def __init__(self, rank: int, world: int):
        import torch.distributed as dist

        self.dist = dist
        self.rank = rank
        self.world = world
        self.seq = 0
        self.stats = {"collectives": 0, "bytes_moved": 0, "host_reductions": 0, "ms": 0.0}
        # one collective at a time: the SPMD launch order admits one
        # query's programs at a time, this only guards the counters
        self._lock = threading.Lock()

    def describe(self) -> dict:
        return {"transport": self.kind, "rank": self.rank, "world": self.world}

    def _guarded(self, name: str, fn):
        import time

        with self._lock:
            self.seq += 1
            seq = self.seq
        t0 = time.perf_counter()
        try:
            return fn()
        except CollectiveError:
            raise
        except Exception as e:  # noqa: BLE001 — every failure names its collective
            raise CollectiveError(
                f"spmd collective {name} #{seq} failed on rank {self.rank}"
                f" of {self.world}: {type(e).__name__}: {e}") from e
        finally:
            self.stats["ms"] += (time.perf_counter() - t0) * 1e3

    def barrier(self) -> None:
        self._guarded("barrier", lambda: self.dist.barrier())

    def reduce_host(self, values: list, ops: list) -> list:
        """The ranks' host values combined word by word (``max`` or
        ``sum``), over gloo on one int64 host tensor a rank."""
        if not values:
            return []

        def run():
            t = torch.tensor([int(v) for v in values], dtype=torch.int64)
            out = [torch.empty_like(t) for _ in range(self.world)]
            self.dist.all_gather(out, t)
            # host tensors: their lists are no device read
            ranks = [o.tolist() for o in out]
            return [max(col) if op == "max" else sum(col)
                    for col, op in zip(zip(*ranks), ops)]

        self.stats["host_reductions"] += 1
        return self._guarded("reduce_host", run)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (one shape on all ranks), stacked in rank
        order: ``[world, *x.shape]``."""
        raise NotImplementedError

    def all_to_all(self, sends: torch.Tensor) -> torch.Tensor:
        """``sends[r]`` goes to rank ``r``; returns what every rank sent
        this one, ``[world, *sends.shape[1:]]`` in source rank order."""
        raise NotImplementedError


class GlooTransport(Transport):
    """Every rank on the CPU: gloo runs the collectives on the tensors."""

    kind = "gloo"

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = _dense(x)

        def run():
            out = torch.empty(self.world * x.numel(), dtype=x.dtype)
            self.dist.all_gather_into_tensor(out, x.reshape(-1))
            return out.reshape((self.world,) + tuple(x.shape))

        self.stats["collectives"] += 1
        self.stats["bytes_moved"] += x.numel() * x.element_size() * (self.world - 1)
        return self._guarded("all_gather", run)

    def all_to_all(self, sends: torch.Tensor) -> torch.Tensor:
        sends = _dense(sends)

        def run():
            out = torch.empty_like(sends)
            self.dist.all_to_all_single(out, sends)
            return out

        self.stats["collectives"] += 1
        block = sends[0].numel() * sends.element_size()
        self.stats["bytes_moved"] += block * (self.world - 1)
        return self._guarded("all_to_all", run)


class PeerTransport(Transport):
    """Every rank on one shared card: peer copies through the ranks'
    exchange arenas, mapped once over CUDA IPC at set-up."""

    kind = "peer"

    def __init__(self, rank: int, world: int, device, arena_bytes: int):
        super().__init__(rank, world)
        from torch.multiprocessing.reductions import reduce_tensor

        self.device = torch.device(device)
        # one slot a destination rank; whole 256-byte lines
        self.slot = max(256, (int(arena_bytes) // world) // 256 * 256)
        self.arena_bytes = self.slot * world
        try:
            self.arena = torch.empty(self.arena_bytes, dtype=torch.uint8, device=self.device)
            rebuild, args = reduce_tensor(self.arena)
            payload = pickle.dumps((rebuild, args))
        except Exception as e:  # noqa: BLE001 — no host-staged detour
            raise CollectiveError(
                f"rank {rank}: the exchange arena of {self.arena_bytes} bytes cannot be"
                f" shared over CUDA IPC ({type(e).__name__}: {e})") from e
        store = _group_store()
        store.set(f"spmd/arena/{rank}", payload)
        torch.cuda.synchronize(self.device)
        self.peers: list[Optional[torch.Tensor]] = []
        for r in range(world):
            if r == rank:
                self.peers.append(self.arena)
                continue
            fn, a = pickle.loads(store.get(f"spmd/arena/{r}"))
            # each peer's handle is opened once, here, for the group's life
            self.peers.append(fn(*a))
        self.barrier()

    def describe(self) -> dict:
        return {**super().describe(), "arena_bytes": self.arena_bytes}

    def _sync(self) -> None:
        torch.cuda.current_stream(self.device).synchronize()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = _dense(x)
        out = torch.empty((self.world,) + tuple(x.shape), dtype=x.dtype, device=self.device)
        src = _bytes(x)
        dst = out.reshape(self.world, -1).view(torch.uint8) if x.numel() else None
        nbytes = src.numel()

        def run():
            for lo in range(0, nbytes, self.arena_bytes):
                hi = min(nbytes, lo + self.arena_bytes)
                self.arena[: hi - lo].copy_(src[lo:hi])
                self._sync()
                self.dist.barrier()
                for r in range(self.world):
                    dst[r, lo:hi].copy_(self.peers[r][: hi - lo])
                self._sync()
                self.dist.barrier()
            return out

        self.stats["collectives"] += 1
        self.stats["bytes_moved"] += nbytes * (self.world - 1)
        if nbytes == 0:
            return out
        return self._guarded("all_gather", run)

    def all_to_all(self, sends: torch.Tensor) -> torch.Tensor:
        sends = _dense(sends)
        out = torch.empty(sends.shape, dtype=sends.dtype, device=self.device)
        per = sends[0].numel() * sends.element_size()
        if per == 0:
            return out
        src = sends.reshape(self.world, -1).view(torch.uint8)
        dst = out.reshape(self.world, -1).view(torch.uint8)
        me = self.rank

        def run():
            for lo in range(0, per, self.slot):
                hi = min(per, lo + self.slot)
                for r in range(self.world):
                    if r != me:
                        base = r * self.slot
                        self.arena[base: base + hi - lo].copy_(src[r, lo:hi])
                dst[me, lo:hi].copy_(src[me, lo:hi])
                self._sync()
                self.dist.barrier()
                for r in range(self.world):
                    if r != me:
                        base = me * self.slot
                        dst[r, lo:hi].copy_(self.peers[r][base: base + hi - lo])
                self._sync()
                self.dist.barrier()
            return out

        self.stats["collectives"] += 1
        self.stats["bytes_moved"] += per * (self.world - 1)
        return self._guarded("all_to_all", run)


def _dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` with row-major strides (a one-row slice of a wider tensor
    counts as contiguous, yet keeps its parent's stride)."""
    want, acc = [], 1
    for size in reversed(x.shape):
        want.append(acc)
        acc *= size
    if tuple(reversed(want)) == tuple(x.stride()):
        return x
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out.copy_(x)
    return out


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view."""
    if x.numel() == 0:
        return torch.empty(0, dtype=torch.uint8, device=x.device)
    return x.reshape(-1).view(torch.uint8)


def _group_store():
    """The store the default group rendezvoused through."""
    import torch.distributed.distributed_c10d as c10d

    return c10d._get_default_store()


_CURRENT: Optional[Transport] = None


def current() -> Optional[Transport]:
    """This process's transport, None outside an SPMD group."""
    return _CURRENT


def install(transport: Optional[Transport]) -> None:
    global _CURRENT
    _CURRENT = transport


def open_transport(device) -> Transport:
    """The transport of the initialized default group for ranks on
    ``device``: gloo where every rank is on the CPU, peer copies where
    every rank is on one card; several cards raise."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        dev = torch.device("cuda", index)
        where = ("cuda", str(torch.cuda.get_device_properties(index).uuid))
    else:
        where = (dev.type, "host")
    places: list = [None] * world
    dist.all_gather_object(places, where)
    if len(set(places)) > 1 or (dev.type != "cuda" and where[0] != "cpu"):
        raise NotImplementedError(
            "ranks of one SPMD group on several devices need NCCL or peer copies"
            f" across cards (ROADMAP item {SEVERAL_CARDS_ITEM}, several cards);"
            f" the ranks are on {places}")
    if dev.type == "cuda":
        return PeerTransport(rank, world, dev, ARENA_BYTES)
    return GlooTransport(rank, world)
