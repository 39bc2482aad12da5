"""A mesh of N shards and sharded batch construction.

Counterpart of ``trino_tpu/parallel/mesh.py``. The engine shards rows on
one mesh axis, ``"shards"`` (Trino's FIXED_HASH_DISTRIBUTION analog). A
sharded column is the reference's row-sharded global array: one tensor
of ``n * cap`` rows, shard-major, so shard ``s`` holds rows
``[s * cap, (s + 1) * cap)``; padding makes the shards' row counts equal
and the selection mask carries validity (``Batch.shards`` records ``n``).
Keeping the reference's layout keeps capacities, bucket sizes and
exchange counters comparable with it number for number.

Every shard of a mesh sits on one device here (the card, or the CPU in
tests). A body that the reference runs under ``shard_map`` is written
once over the ``[n, cap]`` view of its operands, and the collectives are
tensor operations on that view (:func:`all_to_all`, :func:`all_gather`,
:func:`psum`, :func:`pmax`); :func:`smap` runs a body that has no
collective once a shard. Shards on several devices (peer copies or
``torch.distributed``) would come with ``parallel/spmd.py``, the one open
part of ROADMAP item 9c: a mesh over distinct devices raises.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from trino_tpu_torch.columnar import Batch, Column, remap_codes

AXIS = "shards"


class Mesh:
    """N shards over a list of devices (reference: ``jax.sharding.Mesh``
    with the one axis :data:`AXIS`)."""

    def __init__(self, devices: Sequence):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        if len({str(d) for d in devices}) > 1:
            raise NotImplementedError(
                "shards on several devices need peer copies or "
                "torch.distributed (ROADMAP item 9c, parallel/spmd.py); "
                f"got {[str(d) for d in devices]}"
            )
        self.devices = devices
        self.axis_names = (AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({self.size} x {self.device})"


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards (one by default) on ``device``
    (``cuda`` unless the caller names another)."""
    from trino_tpu_torch import resolve_device

    n = int(n_devices or 1)
    if n < 1:
        raise ValueError(f"requested {n} shards")
    return Mesh([resolve_device(device)] * n)


def make_local_mesh(device=None) -> Mesh:
    """The mesh of one process's own devices (reference :42): one shard
    on its card (or on ``device``). A worker process of the cluster tier
    runs its fragments over it."""
    return make_mesh(1, device)


# --- the collectives over the [n, ...] view ----------------------------------


def shard_view(x: torch.Tensor, n: int) -> torch.Tensor:
    """A global shard-major tensor as ``[n, cap, ...]``."""
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def all_to_all(blocks: torch.Tensor) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0)`` of every shard's
    ``[n_dst, B, ...]`` blocks, given as ``[n_src, n_dst, B, ...]``: shard
    ``d`` receives block ``d`` of every source in source order, returned
    as ``[n_dst, n_src * B, ...]``."""
    n_src, n_dst = blocks.shape[0], blocks.shape[1]
    out = blocks.transpose(0, 1)
    return out.reshape((n_dst, n_src * blocks.shape[2]) + tuple(blocks.shape[3:]))


def all_gather(per_shard: torch.Tensor) -> torch.Tensor:
    """Tiled ``lax.all_gather`` of every shard's ``[m, ...]`` part, given
    as ``[n, m, ...]``: the ``[n * m, ...]`` concatenation that every shard
    sees (one tensor, replicated)."""
    return per_shard.reshape((-1,) + tuple(per_shard.shape[2:]))


def psum(per_shard: torch.Tensor) -> torch.Tensor:
    """``lax.psum`` of every shard's value, given stacked on axis 0."""
    return per_shard.sum(0)


def pmax(per_shard: torch.Tensor) -> torch.Tensor:
    """``lax.pmax`` of every shard's value, given stacked on axis 0."""
    return per_shard.amax(0)


def smap(f: Callable, mesh: Mesh, sharded: Sequence):
    """``shard_map`` of a body with no collective: ``f(*locals)`` once a
    shard, ``sharded`` being nested lists and tuples of global shard-major
    tensors (None leaves stay None) that the body sees as the shard's
    slices. The shards' outputs, alike nested,
    concatenate leaf by leaf into global shard-major tensors; a 0-d
    output stacks into one value a shard."""
    from torch.utils import _pytree as pytree

    n = mesh.size
    leaves, spec = pytree.tree_flatten(list(sharded))
    views = [None if x is None else shard_view(x, n) for x in leaves]
    outs = [f(*pytree.tree_unflatten([None if v is None else v[s] for v in views], spec))
            for s in range(n)]
    flat = [pytree.tree_flatten(o) for o in outs]
    joined = [
        None if xs[0] is None else torch.stack(xs) if xs[0].ndim == 0 else torch.cat(xs)
        for xs in zip(*[leaves for leaves, _ in flat])
    ]
    return pytree.tree_unflatten(joined, flat[0][1])


# --- sharded batches (reference :56-169) -------------------------------------


def prepare_shards(mesh: Mesh, parts: Sequence[Batch]):
    """Shard assembly: pad the per-shard parts to one capacity, build
    selection masks, unify dictionaries, remap codes. Returns ``(cap,
    sels, columns)``: ``sels`` None or per-shard bool tensors, ``columns``
    ``[(type, dictionary, datas, valids)]`` with ``valids`` None when every
    part is full-capacity and all valid (reference :56-119)."""
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
    ``Tensor.to`` by default), parts on the mesh's device stay there."""
    n = mesh.size
    cap, sels, columns = prepare_shards(mesh, parts)
    sel = None if sels is None else torch.cat(sels)
    cols = []
    for t, d, datas, valids in columns:
        cols.append(Column(t, torch.cat(datas), None if valids is None else torch.cat(valids), d))
    out = Batch(cols, cap * n, sel, parts[0].device, shards=n)
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


def as_sharded(batch: Batch, n: int) -> Batch:
    """``batch`` seen as sharded over ``n`` shards: rows padded to a
    multiple of ``n`` (unselected), split shard-major (the reference's
    ``_as_global``, ``distributed.py:866``)."""
    if batch.shards == n:
        return batch
    sel = batch.selection_mask()
    cols = [Column(c.type, pad_rows_to(c.data, n),
                   None if c.valid is None else pad_rows_to(c.valid, n, False),
                   c.dictionary) for c in batch.columns]
    sel = pad_rows_to(sel, n, False)
    return Batch(cols, int(sel.shape[0]), sel, batch.device, shards=n)
