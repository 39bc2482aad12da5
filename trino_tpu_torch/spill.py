"""Partitioned execution of the revocable operators (join, aggregate,
sort, window).

Counterpart of ``trino_tpu/spill.py`` (reference: ``spiller/``
``GenericPartitioningSpiller.java``: hash-partition an oversized join or
aggregation state and process the partitions one after another). As in
the reference, the partitioning happens on the host: the row hashes and
the selection come to the host, each row gets its partition there, and
each partition's rows are a host row set. The batches stay on the card
and are sliced by those row sets, and every partition's work runs on the
executor's device, so the card holds one partition's working set (its
join expansion, its sort) at a time beside the inputs.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch.columnar import Batch, Column


def partition_assignment(hashes: np.ndarray, sel: np.ndarray, n_partitions: int) -> np.ndarray:
    """Partition id per row (-1 for unselected rows). ``hashes`` are int64
    with the bits of the reference's uint64 hashes, so the partitions are
    the reference's."""
    part = (hashes.astype(np.uint64) % np.uint64(n_partitions)).astype(np.int64)
    return np.where(sel, part, -1)


def slice_rows(batch: Batch, rows: np.ndarray) -> Batch:
    """The rows ``rows`` (a host row set) of ``batch``, gathered on the
    batch's device into a new compact batch."""
    idx = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64)).to(batch.device)
    cols = [
        Column(c.type, c.data[idx], None if c.valid is None else c.valid[idx], c.dictionary)
        for c in batch.columns
    ]
    return Batch(cols, int(rows.shape[0]), None, batch.device)


def pad_to_one_unselected(batch: Batch) -> Batch:
    """A 1-row batch with nothing selected (kernels reject 0-row arrays)."""
    cols = [
        Column(
            c.type, c.data.new_zeros((1,) + tuple(c.data.shape[1:])),
            torch.zeros(1, dtype=torch.bool, device=c.data.device), c.dictionary,
        )
        for c in batch.columns
    ]
    return Batch(cols, 1, torch.zeros(1, dtype=torch.bool, device=batch.device))


def host_assignments(batches: Sequence[tuple[Batch, torch.Tensor]], n_partitions: int):
    """Per input, its rows' partitions (hashes and selection read to the
    host once)."""
    out = []
    for batch, hashes in batches:
        sel = batch.selection_mask().cpu().numpy()
        out.append(partition_assignment(hashes.cpu().numpy(), sel, n_partitions))
    return out


def partitioned_run(
    batches: Sequence[tuple[Batch, torch.Tensor]],
    n_partitions: int,
    run: Callable[[Sequence[Batch], int], Optional[Batch]],
    stats: Optional[dict] = None,
) -> list[Batch]:
    """Split each (batch, hash) input into hash partitions; call ``run``
    once per partition with the per-input sub-batches. Rows of different
    partitions never join or group together, so per-partition processing
    is exact for equi-joins and group-bys (the GenericPartitioningSpiller
    guarantee). ``stats`` gains the partitions run and the host seconds
    spent partitioning."""
    t0 = time.perf_counter()
    assignments = host_assignments(batches, n_partitions)
    host_s = time.perf_counter() - t0
    out: list[Batch] = []
    for p in range(n_partitions):
        t0 = time.perf_counter()
        rows = [np.nonzero(assign == p)[0] for assign in assignments]
        host_s += time.perf_counter() - t0
        res = run([slice_rows(b, r) for (b, _), r in zip(batches, rows)], p)
        if res is not None and res.num_rows > 0:
            out.append(res)
    if stats is not None:
        stats["partitions"] = stats.get("partitions", 0) + n_partitions
        stats["host_partition_s"] = stats.get("host_partition_s", 0.0) + host_s
    return out
