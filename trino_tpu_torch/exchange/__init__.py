"""Spooled exchange: durable copies of task output that survive the
producing worker's death (reference: Trino's fault-tolerant execution
over a spooled exchange — the Tardigrade ``exchange/`` SPI)."""

from trino_tpu_torch.exchange.spool import (  # noqa: F401
    DiskSpoolStore,
    MemorySpoolStore,
    SpoolStore,
    SpoolWriter,
    get_spool_store,
)
