"""A mesh of N shards and sharded batch construction.

Counterpart of ``trino_tpu/parallel/mesh.py``. The engine shards rows on
one mesh axis, ``"shards"`` (Trino's FIXED_HASH_DISTRIBUTION analog). A
sharded column is the reference's row-sharded global array: one tensor
of ``n * cap`` rows, shard-major, so shard ``s`` holds rows
``[s * cap, (s + 1) * cap)``; padding makes the shards' row counts equal
and the selection mask carries validity (``Batch.shards`` records ``n``).
Keeping the reference's layout keeps capacities, bucket sizes and
exchange counters comparable with it number for number.

In one process every shard of a mesh sits on one device (the card, or
the CPU in tests). A body that the reference runs under ``shard_map`` is
written once over the ``[n, cap]`` view of its operands, and the
collectives are tensor operations on that view (:func:`all_to_all`,
:func:`all_gather`, :func:`psum`, :func:`pmax`); :func:`smap` runs a
body that has no collective once a shard.

A mesh can also span the server processes of one SPMD group
(``parallel/spmd.py``): ``world`` processes, this one of ``rank``, each
holding ``local`` shards (one, its own), ``size = world * local`` in
all. A sharded tensor of such a process holds only its local shards'
rows (``local * cap``), the slice the one-process layout gives them; a
tensor that is not sharded is replicated, every process holding all of
it. The bodies run over the ``[local, cap]`` view, and the collectives
take the mesh and cross processes through its transport
(``parallel/transport.py``): gloo on the CPU, peer copies between
processes that share one card (NCCL refuses two ranks on one device;
CUDA IPC does not). With ``world == 1`` every function computes what it
computes without a group. Shards on several cards raise (ROADMAP item
9c, its several-cards part).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from trino_tpu_torch.columnar import Batch, Column, remap_codes

AXIS = "shards"


class Mesh:
    """N shards over a list of devices (reference: ``jax.sharding.Mesh``
    with the one axis :data:`AXIS`)."""

    def __init__(self, devices: Sequence, rank: int = 0, world: int = 1, transport=None):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        if len({str(d) for d in devices}) > 1:
            raise NotImplementedError(
                "shards on several devices need NCCL or peer copies across "
                "cards (ROADMAP item 9c, several cards); "
                f"got {[str(d) for d in devices]}"
            )
        if world > 1 and transport is None:
            raise ValueError("a mesh over several processes needs their transport")
        self.devices = devices
        self.axis_names = (AXIS,)
        # the SPMD group: this process's rank of ``world``
        self.rank = int(rank)
        self.world = int(world)
        self.transport = transport

    @property
    def local(self) -> int:
        """The shards this process holds."""
        return len(self.devices)

    @property
    def size(self) -> int:
        """The mesh's shards over every process."""
        return self.world * len(self.devices)

    @property
    def first(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def spans(self) -> bool:
        """Does the mesh span several processes?"""
        return self.world > 1

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def reduce_host(self, values: list, ops: list) -> list:
        """Host values combined over the processes word by word (``max``
        or ``sum``); the values themselves with one process."""
        if not self.spans:
            return list(values)
        return self.transport.reduce_host(values, ops)

    def __repr__(self) -> str:
        if self.spans:
            return f"Mesh({self.size} x {self.device}, rank {self.rank} of {self.world})"
        return f"Mesh({self.size} x {self.device})"


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards (one by default) on ``device``
    (``cuda`` unless the caller names another). In a process of an SPMD
    group (``parallel/spmd.py::initialize_spmd``) the default mesh spans
    the group, one shard a process, as the reference's ``make_mesh()``
    spans every process's devices."""
    from trino_tpu_torch import resolve_device
    from trino_tpu_torch.parallel import transport as TR

    group = TR.current()
    if n_devices is None and group is not None:
        return Mesh([resolve_device(device)], group.rank, group.world, group)
    n = int(n_devices or 1)
    if n < 1:
        raise ValueError(f"requested {n} shards")
    return Mesh([resolve_device(device)] * n)


def make_local_mesh(device=None) -> Mesh:
    """The mesh of one process's own devices (reference :42): one shard
    on its card (or on ``device``). A worker process of the cluster tier
    runs its fragments over it; inside an SPMD group too, where per-task
    execution must not span processes."""
    return make_mesh(1, device)


# --- the collectives over the [n, ...] view ----------------------------------


def shard_view(x: torch.Tensor, n: int) -> torch.Tensor:
    """A global shard-major tensor as ``[n, cap, ...]``."""
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def all_to_all(blocks: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0)`` of every shard's
    ``[n_dst, B, ...]`` blocks, given as ``[n_src, n_dst, B, ...]``: shard
    ``d`` receives block ``d`` of every source in source order, returned
    as ``[n_dst, n_src * B, ...]``. On a mesh over processes the sources
    and destinations are this process's local shards and the blocks of
    the other processes' shards cross through the transport."""
    if mesh is None or not mesh.spans:
        n_src, n_dst = blocks.shape[0], blocks.shape[1]
        out = blocks.transpose(0, 1)
        return out.reshape((n_dst, n_src * blocks.shape[2]) + tuple(blocks.shape[3:]))
    L, W = mesh.local, mesh.world
    rest = tuple(blocks.shape[2:])
    # [L_src, W, L_dst, B, ...] -> the blocks for rank r at sends[r]
    sends = blocks.reshape((L, W, L) + rest).transpose(0, 1)
    recv = mesh.transport.all_to_all(sends.contiguous())  # [W, L_src, L_dst, B, ...]
    out = recv.reshape((W * L, L) + rest).transpose(0, 1)
    return out.reshape((L, W * L * rest[0]) + rest[1:])


def flat(per_shard: torch.Tensor) -> torch.Tensor:
    """The shards' ``[n, m, ...]`` parts as one shard-major sharded
    tensor of ``n * m`` rows (no data crosses a shard)."""
    return per_shard.reshape((-1,) + tuple(per_shard.shape[2:]))


def all_gather(per_shard: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Tiled ``lax.all_gather`` of every shard's ``[m, ...]`` part, given
    as ``[n, m, ...]`` (this process's ``local`` shards on a mesh over
    processes): the ``[size * m, ...]`` concatenation that every shard
    sees (one tensor, replicated)."""
    if mesh is None or not mesh.spans:
        return flat(per_shard)
    got = mesh.transport.all_gather(per_shard.contiguous())  # [W, L, m, ...]
    return got.reshape((-1,) + tuple(per_shard.shape[2:]))


def psum(per_shard: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``lax.psum`` of every shard's value, given stacked on axis 0."""
    return all_gather(per_shard.unsqueeze(1), mesh).sum(0)


def pmax(per_shard: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``lax.pmax`` of every shard's value, given stacked on axis 0."""
    return all_gather(per_shard.unsqueeze(1), mesh).amax(0)


def smap(f: Callable, mesh: Mesh, sharded: Sequence):
    """``shard_map`` of a body with no collective: ``f(*locals)`` once a
    shard, ``sharded`` being nested lists and tuples of global shard-major
    tensors (None leaves stay None) that the body sees as the shard's
    slices. The shards' outputs, alike nested,
    concatenate leaf by leaf into global shard-major tensors; a 0-d
    output stacks into one value a shard. On a mesh over processes the
    body runs over this process's local shards."""
    from torch.utils import _pytree as pytree

    n = mesh.local
    leaves, spec = pytree.tree_flatten(list(sharded))
    views = [None if x is None else shard_view(x, n) for x in leaves]
    outs = [f(*pytree.tree_unflatten([None if v is None else v[s] for v in views], spec))
            for s in range(n)]
    flats = [pytree.tree_flatten(o) for o in outs]
    joined = [
        None if xs[0] is None else torch.stack(xs) if xs[0].ndim == 0 else torch.cat(xs)
        for xs in zip(*[leaves for leaves, _ in flats])
    ]
    return pytree.tree_unflatten(joined, flats[0][1])


# --- sharded batches (reference :56-169) -------------------------------------


def prepare_shards(mesh: Mesh, parts: Sequence[Batch]):
    """Shard assembly: pad the per-shard parts to one capacity, build
    selection masks, unify dictionaries, remap codes. Returns ``(cap,
    sels, columns)``: ``sels`` None or per-shard bool tensors, ``columns``
    ``[(type, dictionary, datas, valids)]`` with ``valids`` None when every
    part is full-capacity and all valid (reference :56-119). Every part is
    assembled on every process of a mesh over processes, so that all of
    them unify the dictionaries alike (the reference's ``_global``)."""
    n = mesh.size
    assert len(parts) == n, f"need {n} parts, got {len(parts)}"
    cap = max(1, max(p.capacity for p in parts))
    width = parts[0].width
    dev = parts[0].device
    # full parts with no selection need no mask
    if all(p.sel is None and p.num_rows == cap == p.capacity for p in parts):
        sels = None
    else:
        sels = []
        for p in parts:
            mask = torch.zeros(cap, dtype=torch.bool, device=dev)
            mask[: p.num_rows] = True
            if p.sel is not None:
                local = torch.zeros(cap, dtype=torch.bool, device=dev)
                local[: p.capacity] = p.sel.to(dev)
                mask &= local
            sels.append(mask)
    dictionaries = _unify_part_dictionaries(parts)
    columns = []
    for j in range(width):
        t = parts[0].columns[j].type
        datas, valids = [], []
        no_valid = all(
            p.columns[j].valid is None and p.columns[j].capacity == cap for p in parts
        )
        for pi, p in enumerate(parts):
            c = p.columns[j]
            data = c.data.to(dev)
            if dictionaries[j] is not None and c.dictionary is not None:
                remap = dictionaries[j][1][pi]
                if remap is not None:
                    data = remap_codes(data, remap)
            if data.shape[0] < cap:
                # wide DECIMAL columns carry (N, 2) hi/lo lanes: pad rows
                pad = data.new_zeros((cap - data.shape[0],) + tuple(data.shape[1:]))
                data = torch.cat([data, pad])
            datas.append(data)
            if not no_valid:
                valid = torch.ones(cap, dtype=torch.bool, device=dev)
                if c.valid is not None:
                    v = c.valid.to(dev)
                    valid[: v.shape[0]] = v
                    valid[v.shape[0]:] = False
                valids.append(valid)
        d = dictionaries[j][0] if dictionaries[j] is not None else None
        columns.append((t, d, datas, None if no_valid else valids))
    return cap, sels, columns


def shard_batch(mesh: Mesh, parts: Sequence[Batch], to_device: Optional[Callable] = None) -> Batch:
    """One sharded batch of the per-shard ``parts`` (same schema), padded
    to the largest part's capacity; its ``sel`` masks the padding. Parts
    on the host are assembled there and moved by ``to_device`` (one copy;
    ``Tensor.to`` by default), parts on the mesh's device stay there. On a
    mesh over processes only this process's parts are kept and moved."""
    n = mesh.size
    cap, sels, columns = prepare_shards(mesh, parts)
    lo, hi = mesh.first, mesh.first + mesh.local
    sel = None if sels is None else torch.cat(sels[lo:hi])
    cols = []
    for t, d, datas, valids in columns:
        cols.append(Column(t, torch.cat(datas[lo:hi]),
                           None if valids is None else torch.cat(valids[lo:hi]), d))
    out = Batch(cols, cap * mesh.local, sel, parts[0].device, shards=n)
    if out.device != mesh.device:
        moved = to_device(out) if to_device is not None else out.to(mesh.device)
        out = Batch(moved.columns, moved.num_rows, moved.sel, mesh.device, shards=n)
    return out


def _unify_part_dictionaries(parts: Sequence[Batch]):
    """Per column: the parts' dictionaries merged into one, and the remap
    table of each part (None where its codes stand)."""
    out = []
    for j in range(parts[0].width):
        dicts = [p.columns[j].dictionary for p in parts]
        if all(d is None for d in dicts):
            out.append(None)
            continue
        base = None
        remaps = []
        for d in dicts:
            if d is None:
                remaps.append(None)
                continue
            if base is None:
                base = d
                remaps.append(None)
            elif d is base:
                remaps.append(None)
            else:
                base, remap = base.merged(d)
                remaps.append(remap)
        out.append((base, remaps))
    return out


def pad_rows_to(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """``x`` with rows appended up to a multiple of ``n``."""
    pad = (-x.shape[0]) % n
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def as_sharded(batch: Batch, mesh: Mesh) -> Batch:
    """``batch`` seen as sharded over the mesh's shards: rows padded to a
    multiple of ``n`` (unselected), split shard-major (the reference's
    ``_as_global``, ``distributed.py:866``). On a mesh over processes a
    batch that is not sharded is replicated, and this process keeps its
    local shards' slice of it."""
    n = mesh.size
    if batch.shards == n:
        return batch
    sel = batch.selection_mask()
    cols = [Column(c.type, pad_rows_to(c.data, n),
                   None if c.valid is None else pad_rows_to(c.valid, n, False),
                   c.dictionary) for c in batch.columns]
    sel = pad_rows_to(sel, n, False)
    if mesh.spans:
        per = sel.shape[0] // n
        lo, hi = mesh.first * per, (mesh.first + mesh.local) * per
        cols = [Column(c.type, c.data[lo:hi], None if c.valid is None else c.valid[lo:hi],
                       c.dictionary) for c in cols]
        sel = sel[lo:hi]
    return Batch(cols, int(sel.shape[0]), sel, batch.device, shards=n)


def is_local(batch: Batch, mesh: Optional[Mesh]) -> bool:
    """Does ``batch`` hold only this process's shards of a mesh over
    processes (rather than all of its rows)?"""
    return mesh is not None and mesh.spans and batch.shards == mesh.size


def replicate(batch: Batch, mesh: Optional[Mesh]) -> Batch:
    """A batch of this process's shards gathered from every process: the
    one-process mesh's shard-major tensor, held by every process (not
    sharded any more). Any other batch as it is."""
    if not is_local(batch, mesh):
        return batch
    L = mesh.local

    def gather(x):
        return all_gather(shard_view(x, L), mesh)

    sel = gather(batch.selection_mask())
    cols = [Column(c.type, gather(c.data), None if c.valid is None else gather(c.valid),
                   c.dictionary) for c in batch.columns]
    return Batch(cols, int(sel.shape[0]), sel, batch.device)
