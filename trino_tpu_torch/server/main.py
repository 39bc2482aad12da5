"""Server entry point: ``python -m trino_tpu_torch.server.main``.

Reference: ``server/Server.java:73`` — one binary, coordinator vs worker by
config. A copy of ``trino_tpu/server/main.py`` for the coordinator role:
``--device`` (``cuda`` by default, ``cpu`` on a machine without a GPU)
takes the place of ``--platform``, and the cluster's options (``--role
worker``, ``--discovery``, ``--spmd-coordinator``, a non-zero
``--spmd-procs`` or ``--spmd-rank``) refuse with ROADMAP item 9c named.
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
                        help="coordinator URI (workers; not yet ported)")
    parser.add_argument(
        "--device",
        default=None,
        help="torch device of the engine (default cuda; cpu runs on the host)",
    )
    parser.add_argument(
        "--spmd-coordinator",
        default=None,
        help="multi-host SPMD coordinator host:port (not yet ported)",
    )
    parser.add_argument("--spmd-procs", type=int, default=0,
                        help="SPMD process count (not yet ported)")
    parser.add_argument("--spmd-rank", type=int, default=0,
                        help="SPMD process rank (not yet ported)")
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
        help="cluster-wide memory ceiling reported at /v1/memory",
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

    from trino_tpu_torch.server.http import TrinoTpuServer, refuse_cluster_options

    refuse_cluster_options(
        args.role,
        bool(args.spmd_coordinator or args.spmd_procs or args.spmd_rank),
        args.discovery,
    )

    from trino_tpu_torch.engine import Engine

    engine = Engine(device=args.device)
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
        node_id=args.node_id,
        cluster_memory_limit_bytes=args.cluster_memory_limit_bytes,
        server_config=server_config,
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
        # a drained coordinator (PUT /v1/info/state SHUTTING_DOWN) stops
        # its server itself; the process then exits
        while not stop["flag"] and server.state != "STOPPED":
            time.sleep(0.2)
    finally:
        if server.state != "STOPPED":
            server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
