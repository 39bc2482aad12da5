"""Server entry point: ``python -m trino_tpu_torch.server.main``.

Reference: ``server/Server.java:73`` — one binary, coordinator vs worker by
config. Workers take ``--discovery`` pointing at the coordinator and
announce themselves (DiscoveryNodeManager analog in server/cluster.py).

A copy of ``trino_tpu/server/main.py``: ``--device`` (``cuda`` by default,
``cpu`` on a machine without a GPU) takes the place of ``--platform``; a
worker on a machine with a card refuses ``--device cpu``. ``--card-share``
is the process's share of its card where a coordinator and its workers
share one card (``memory.set_card_share``; the reference has none: a TPU
chip is never shared by processes). On a card the process loads the hand
kernels' libraries at boot (built into ``.kernel_build/`` if missing).
SPMD (``--spmd-coordinator`` with ``--spmd-procs`` and ``--spmd-rank``)
joins the process group (``parallel/spmd.py::initialize_spmd``: gloo on
the CPU, peer copies through the card's exchange arenas) after the card
share is set and before the engine exists, and serves ``/v1/spmd``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="trino-tpu server (PyTorch/CUDA)")
    parser.add_argument("--role", choices=["coordinator", "worker"], default="coordinator")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--node-id", default=None)
    parser.add_argument("--discovery", "--discovery-uri", default=None,
                        help="coordinator URI (workers)")
    parser.add_argument(
        "--device",
        default=None,
        help="torch device of the engine (default cuda; cpu runs on the host)",
    )
    parser.add_argument(
        "--card-share",
        type=float,
        default=1.0,
        help="this process's share of its card, in (0, 1]: every memory"
        " budget reads it and the caching allocator is bound to it",
    )
    parser.add_argument(
        "--spmd-coordinator",
        default=None,
        help="SPMD process group rendezvous host:port (enables SPMD)",
    )
    parser.add_argument("--spmd-procs", type=int, default=0,
                        help="SPMD process count (with --spmd-coordinator)")
    parser.add_argument("--spmd-rank", type=int, default=0,
                        help="this process's SPMD rank (0: the coordinator)")
    parser.add_argument(
        "--catalog",
        action="append",
        default=[],
        help="register a catalog: name=kind[:arg] (etc/catalog analog)",
    )
    parser.add_argument(
        "--cluster-memory-limit-bytes",
        type=int,
        default=None,
        help="coordinator-enforced cluster-wide memory ceiling",
    )
    parser.add_argument(
        "--max-inflight-requests",
        type=int,
        default=None,
        help="global ceiling on concurrently handled external requests"
        " (excess shed with 503 + Retry-After)",
    )
    parser.add_argument(
        "--tenant-rate-limit-qps",
        type=float,
        default=None,
        help="per-tenant statement token-bucket refill rate (0 disables)",
    )
    parser.add_argument(
        "--client-timeout-s",
        type=float,
        default=None,
        help="cancel a query unpolled by its client for this long",
    )
    parser.add_argument(
        "--result-page-max-bytes",
        type=int,
        default=None,
        help="byte budget per streamed result page (0 = materialized)",
    )
    args = parser.parse_args(argv)

    from trino_tpu_torch.server.http import TrinoTpuServer

    if not args.spmd_coordinator and (args.spmd_procs or args.spmd_rank):
        parser.error("--spmd-procs and --spmd-rank need --spmd-coordinator")
    if args.spmd_coordinator and not 0 <= args.spmd_rank < args.spmd_procs:
        parser.error("SPMD needs --spmd-procs N and --spmd-rank in [0, N)")

    import torch

    from trino_tpu_torch import resolve_device
    from trino_tpu_torch.engine import Engine
    from trino_tpu_torch.memory import set_card_share

    device = resolve_device(args.device)
    if args.role == "worker" and device.type != "cuda" and torch.cuda.is_available():
        # no fallback: a worker on a machine with a card runs on the card
        parser.error("a worker on a machine with a GPU runs on the GPU (--device cuda)")
    set_card_share(args.card_share, device)
    if args.spmd_coordinator:
        # the group and its data plane before the engine touches the card
        from trino_tpu_torch.parallel.spmd import initialize_spmd

        initialize_spmd(args.spmd_coordinator, args.spmd_procs, args.spmd_rank, device)
    if device.type == "cuda":
        # the CUDA context and the hand kernels' libraries at boot
        from trino_tpu_torch import _kernels

        torch.zeros(1, device=device)
        _kernels.build_all()
        for name in _kernels.LAUNCHES:
            _kernels.load(name)
    engine = Engine(device=device)
    if args.catalog:
        from trino_tpu_torch.connectors.api import register_catalog_spec

        for spec in args.catalog:
            register_catalog_spec(engine.catalogs, spec)

    server_config = None
    overrides = {
        "max_inflight_requests": args.max_inflight_requests,
        "tenant_rate_limit_qps": args.tenant_rate_limit_qps,
        "client_timeout_s": args.client_timeout_s,
        "result_page_max_bytes": args.result_page_max_bytes,
    }
    if any(v is not None for v in overrides.values()):
        from trino_tpu_torch.config import ServerConfig

        server_config = ServerConfig(
            **{k: v for k, v in overrides.items() if v is not None}
        )

    server = TrinoTpuServer(
        engine=engine,
        host=args.host,
        port=args.port,
        role=args.role,
        node_id=args.node_id,
        discovery_uri=args.discovery,
        cluster_memory_limit_bytes=args.cluster_memory_limit_bytes,
        server_config=server_config,
        spmd=bool(args.spmd_coordinator),
    )
    server.start()
    # parent supervisors (tests, orchestration) read this line
    print(f"LISTENING {server.base_uri}", flush=True)

    stop = {"flag": False}

    def on_term(_sig, _frm):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    try:
        # a drained worker (PUT /v1/info/state SHUTTING_DOWN) stops its
        # server itself; the process must then exit so rolling restarts
        # can respawn it
        while not stop["flag"] and server.state != "STOPPED":
            time.sleep(0.2)
    finally:
        if server.state != "STOPPED":
            server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
