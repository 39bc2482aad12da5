"""Global configuration and session properties.

Reference: Trino's session property system
(``core/trino-main/src/main/java/io/trino/SystemSessionProperties.java:50``)
and airlift ``@Config`` classes. Here: a plain dataclass of typed session
properties, overridable per query.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar


@dataclasses.dataclass
class Session:
    """Per-query session (reference: ``io.trino.Session``).

    ``properties`` mirrors SET SESSION overrides
    (``SystemSessionProperties.java``); only properties our engine consults
    are defined, with typed defaults.
    """

    user: str = "user"
    catalog: str | None = "tpch"
    schema: str | None = "tiny"
    source: str = ""  # client-declared source (X-Trino-Source)
    properties: dict[str, Any] = dataclasses.field(default_factory=dict)
    # prepared statements (reference: Session.preparedStatements)
    prepared: dict[str, Any] = dataclasses.field(default_factory=dict)

    # --- defaults for recognised properties -------------------------------
    DEFAULTS: ClassVar[tuple[tuple[str, Any], ...]] = (
        ("join_distribution_type", "AUTOMATIC"),  # BROADCAST | PARTITIONED
        ("join_reordering_strategy", "AUTOMATIC"),
        ("task_concurrency", 1),
        ("batch_capacity", 1 << 16),  # padded kernel batch rows
        ("broadcast_join_threshold_rows", 1 << 22),
        # --- dense join tier (ops/dense_join.py) --------------------------
        # master switch for the open-addressing join engine: dense build
        # tables with graceful overflow (densejoin@ capacity sites), the
        # spill-cliff removal, and broadcast-link star-join fusion
        ("dense_join", True),
        # auto | sort | dense | matmul — auto picks dense for INNER/LEFT
        # equi-joins and escalates single-key dense-domain builds to the
        # binned (matmul) tier when PR-15 history proves the domain fits
        ("join_strategy", "auto"),
        # largest binned key domain the auto gate may promote to the
        # matmul tier (explicit join_strategy=matmul is not bounded)
        ("matmul_join_max_domain", 1 << 13),
        ("enable_dynamic_filtering", True),
        ("dynamic_filtering_max_build_rows", 1 << 20),
        ("query_max_memory_bytes", 8 << 30),
        ("spill_enabled", True),
        ("spill_partitions", 8),
        # rows above which join/group-by switch to partitioned host-spill
        ("spill_threshold_rows", 1 << 23),
        ("tpu_enabled", True),
        # plan sanity checkers after each optimizer stage, fragmentation,
        # and worker-side deserialization (reference PlanSanityChecker)
        ("plan_validation", True),
        ("execution_mode", "local"),  # local | distributed (mesh SPMD)
        # cluster worker tasks: 'fused' compiles the fragment onto the
        # worker's local devices; 'interpreter' forces the CPU fallback
        ("worker_execution", "fused"),
        # stage launch order: all-at-once | phased (build-before-probe;
        # reference AllAtOnceExecutionPolicy / PhasedExecutionPolicy)
        ("execution_policy", "all-at-once"),
        # distributed writer tasks over shared-storage connectors
        # (ScaledWriterScheduler analog; see Engine._scaled_insert ADR)
        ("scaled_writers", False),
        ("writer_target_bytes", 32 << 20),
        # streaming scans (Driver-loop analog): scan->agg fragments whose
        # table exceeds the threshold run as a chunk loop with carried
        # accumulators instead of materializing the table on device
        ("stream_scan_threshold_rows", 1 << 22),
        ("stream_chunk_rows", 1 << 20),
        # device-resident streaming: connectors that can stage a table
        # into HBM (memory connector) stream it via in-program
        # dynamic_slice chunks; cap on staged bytes per table
        ("stream_device_cache_bytes", 4 << 30),
        # 2M rows: the in-loop int64 cumsum's reduce-window must fit
        # scoped vmem (16MB on v5e; 4M-row chunks exceed it)
        ("stream_device_chunk_rows", 1 << 21),
        # initial per-shard group budget for streamed aggregation (grows
        # on overflow)
        ("stream_group_budget", 1 << 12),
        # distributed mode: compile each plan fragment into one SPMD
        # program (exec/fragments.py); off -> materialized interpreter
        ("fragment_execution", True),
        # --- whole-pipeline fusion (planner/fragmenter.py fuse_groups) ----
        # compile chains of fragments connected by eligible HASH (and
        # gather) exchanges into ONE jitted program with the repartition
        # collectives inside the jit, instead of one dispatch per
        # fragment; ineligible links fall back to the per-fragment path
        # bit-identically
        ("pipeline_fusion", True),
        # cap on fragments per fused program (bounds compile time and
        # scoped-vmem pressure of the merged XLA program)
        ("fusion_max_fragments", 8),
        # --- fault tolerance (trino_tpu/ft/) ------------------------------
        # NONE | TASK | QUERY (reference: io.trino.execution.RetryPolicy).
        # TASK re-dispatches a failed fragment attempt to another worker
        # over retained (materialized) exchange output; QUERY re-runs the
        # whole statement on a fresh attempt id.
        ("retry_policy", "NONE"),
        ("task_retry_attempts", 4),  # total attempts per task (incl. first)
        ("query_retry_attempts", 3),  # total attempts per query (incl. first)
        ("retry_initial_delay_ms", 100),
        ("retry_max_delay_ms", 2000),
        # spooled exchange (trino_tpu/exchange/spool.py): under TASK
        # retry, workers asynchronously copy finished output-buffer pages
        # to a coordinator-hosted spool store, so a producer's death
        # recovers by re-pointing consumers at the spool (level=task) or
        # re-executing only the lost producers (level=lineage) instead of
        # falling back to a QUERY retry
        ("exchange_spooling", False),
        ("spool_dir", ""),  # "" = host-RAM backend; path = local disk
        ("spool_max_bytes", 256 << 20),
        # deterministic fault injection (chaos testing; ft/injection.py):
        # all probabilities zero -> injection fully disabled
        ("fault_injection_seed", 0),
        ("fault_task_crash_p", 0.0),
        ("fault_http_drop_p", 0.0),
        ("fault_http_delay_ms", 0),
        # delay faults: deterministic per-node slowdowns at task-execute
        # sites so chaos tests can manufacture stragglers. fault_slow_workers
        # is a comma-separated node-id list ("" = every node once a delay
        # fault is configured); stall is a fixed pre-execute sleep, factor
        # scales the measured execution time (10.0 -> a 10x-slow worker)
        ("fault_slow_workers", ""),
        ("fault_task_stall_ms", 0),
        ("fault_task_slow_factor", 1.0),
        # worker-death faults: once a task at fault site
        # "task:{fragment}.{partition}" finishes on a matching node
        # (fault_worker_exit_node, "" = any), the worker process exits
        # hard (os._exit) after fault_worker_exit_delay_ms — simulating
        # SIGKILL for spool/lineage recovery tests. "" site = disabled.
        ("fault_worker_exit_node", ""),
        ("fault_worker_exit_site", ""),
        ("fault_worker_exit_delay_ms", 0),
        # --- speculative (hedged) task execution (server/cluster.py) ------
        # under retry_policy=TASK: when a running attempt's elapsed exceeds
        # max(floor, multiplier * p99 of completed siblings), dispatch one
        # duplicate on a different healthy node; first finisher wins, the
        # loser is cancelled (token-acked buffers dedupe delivery)
        ("speculation", False),
        ("speculation_floor_ms", 500),
        ("speculation_multiplier", 2.0),
        # cap on concurrent speculative attempts per query, as a fraction
        # of the query's planned task count (min 1 when speculation is on)
        ("speculation_max_fraction", 0.25),
        # --- internal HTTP tuning (chaos tests shrink these) --------------
        ("http_request_timeout_s", 30.0),  # task POST/GET/DELETE calls
        ("http_retry_attempts", 3),  # transient-error retries per request
        ("exchange_timeout_s", 300.0),  # total page-exchange read budget
        ("exchange_poll_s", 15.0),  # server-side long-poll hold per GET
        # per-task output buffer cap; TASK retry retains delivered pages
        # (materialized exchange), so give it headroom
        ("exchange_buffer_bytes", 64 << 20),
        # --- skew-aware exchange (ops/skew.py, parallel/exchange.py) ------
        # detect heavy-hitter join keys and route them on a salted path
        # (hot build keys replicated, hot probe rows kept local)
        ("skew_handling", True),
        # seed _Caps defaults from planner/stats.py estimates per
        # exchange/join/agg site (provenance recorded in /v1/query)
        ("stats_capacity_seeding", True),
        ("skew_hot_k", 16),  # top-k candidates per shard in the sketch
        # hot iff global count > frac * (total_rows / n_shards)
        ("skew_hot_threshold_frac", 0.5),
        # --- cross-query program cache (planner/canonicalize.py) ----------
        # share compiled fragment programs across statements under a
        # canonical-plan fingerprint (ExpressionCompiler CacheKey analog);
        # off -> every statement plans and traces from scratch
        ("program_cache", True),
        # hoist non-structural literals out of the plan into the jit
        # parameter vector so `x < 24` and `x < 25` share one traced
        # program; off -> literals bake into the trace (old behavior)
        ("constant_hoisting", True),
        # --- device-level profiling (obs/profiler.py) ---------------------
        # capture XLA cost_analysis/memory_analysis per compiled fragment
        # program (AOT lower+compile of the SAME jitted function, so query
        # results are bit-identical on or off); deliberately NOT part of
        # the canonical-plan fingerprint (planner/canonicalize.py) for the
        # same reason
        ("device_profiling", True),
        # --- columnar ingest tier (trino_tpu/ingest.py) --------------------
        # decode host columns with the native C hot loops when the shared
        # library built; off -> pure-Python/numpy fallback (bit-identical)
        ("native_decode", True),
        # two-slot double-buffered split decode: a background thread
        # decodes split k+1 while the device executes over split k
        ("ingest_prefetch", True),
        # pack every column of a shard into one contiguous uint32 staging
        # arena and issue a single H2D transfer per device (sliced back
        # into columns on-device), amortizing the per-transfer DMA floor;
        # off -> per-column device_put (bit-identical)
        ("coalesced_h2d", True),
        # below this many raw bytes a scan stays per-column even with
        # coalesced_h2d on: cold scans are unpack-program-cold too, and a
        # few DMA floors cost less than the first-touch XLA compile
        ("coalesce_min_bytes", 1 << 23),
        # device-resident table cache: keep scanned tables HBM-resident
        # across queries keyed by (catalog, table, version, projection,
        # splits); warm repeat scans issue zero H2D bytes
        ("table_cache", True),
        ("table_cache_max_bytes", 1 << 30),
        # --- semantic result cache (trino_tpu/cache/result_cache.py) -------
        # coordinator-level final-result reuse keyed by (canonical plan
        # fingerprint, hoisted-param vector, per-catalog data versions,
        # ACL generation): a warm repeat returns in microseconds with zero
        # device dispatches. Off by default — serving tiers opt in per
        # session (existing warm-repeat tests assert real executions).
        ("result_cache", False),
        ("result_cache_max_bytes", 64 << 20),
        # on an append-only data_versions() delta, re-execute the cached
        # aggregation plan over ONLY the new parts and merge partial
        # aggregates into the cached rows instead of invalidating;
        # non-maintainable shapes invalidate as before
        ("incremental_maintenance", True),
        # --- cross-query device batching (exec/batching.py) ----------------
        # hold compatible queries (same canonical-plan fingerprint,
        # differing only in hoisted literals) for a short window and
        # execute ONE stacked dispatch through the cached program,
        # demultiplexing K result sets — bit-identical to K sequential
        # runs. 0 disables collection entirely (today's behavior).
        ("batch_window_ms", 0),
        # flush a collecting batch early once this many members joined
        ("batch_max_size", 16),
        # --- query history (obs/history.py) --------------------------------
        # record per-fingerprint observed execution truth (final
        # capacities, overflow retries, peak HBM, elapsed, ...) and seed
        # warm repeats from it; bit-identical on/off
        ("query_history", True),
        # where the history JSON lives; "" keeps the store in-memory only
        # (per-process) — set a directory to survive restarts and share
        # across engines
        ("history_dir", ""),
        ("history_max_entries", 256),
        ("history_max_bytes", 1 << 20),
        # retained terminal queries in the coordinator QueryManager
        # (satellite of the same observability story: coordinator memory
        # under sustained traffic)
        ("query_manager_max_history", 100),
        # --- operator telemetry (exec/fragments.py tracer) ------------------
        # per-operator input/output row counters minted inside the traced
        # program (scan/filter/join/agg/exchange), riding the existing
        # deferred-counter pull: zero extra D2H round trips, bit-identical
        # results on/off. Unlike device_profiling this IS part of the
        # canonical-plan fingerprint — the extra reductions change the
        # compiled program.
        ("operator_stats", True),
        # --- flight recorder (obs/flight.py) --------------------------------
        # crash-safe on-disk journal of query lifecycle events; "" disables
        # journaling (tier-1 default: no cross-process state)
        ("flight_dir", ""),
        ("flight_max_bytes", 16 << 20),
        ("flight_segment_bytes", 1 << 20),
        # --- SLO regression sentinel (obs/slo.py) ---------------------------
        # absolute elapsed-time SLO per query in ms; 0 = no absolute SLO
        # (history-relative regressions still fire)
        ("slo_elapsed_ms", 0.0),
        # a completion regresses when elapsed > multiplier * the
        # fingerprint's history p50 baseline (severe at severe_multiplier),
        # once the baseline holds at least slo_min_samples samples
        ("slo_regression_multiplier", 2.0),
        ("slo_severe_multiplier", 4.0),
        ("slo_min_samples", 3),
    )

    def get(self, name: str) -> Any:
        if name in self.properties:
            return self.properties[name]
        for key, default in self.DEFAULTS:
            if key == name:
                return default
        raise KeyError(f"unknown session property: {name}")

    def set(self, name: str, value: Any) -> None:
        self.properties[name] = value


@dataclasses.dataclass
class ServerConfig:
    """Front-door (HTTP serving tier) knobs, analogous to airlift's
    ``HttpServerConfig`` + Trino's ``QueryManagerConfig`` client-timeout.

    These govern the serving edge — connection budgets, shedding, result
    paging — not query semantics, so they live apart from ``Session``.
    """

    # Global ceiling on requests concurrently occupying blocking-pool
    # workers; excess requests shed with 503 + Retry-After.
    max_inflight_requests: int = 256
    # Per-tenant (X-Trino-User) statement-submission rate limit; 0 = off.
    tenant_rate_limit_qps: float = 0.0
    tenant_rate_limit_burst: float = 16.0
    # A query whose nextUri goes unpolled this long is canceled and its
    # admission slot freed (reference: Trino query.client.timeout).
    client_timeout_s: float = 120.0
    # Byte budget per result page served off the streaming pager; <= 0
    # falls back to fixed row-count pages over the materialized result.
    result_page_max_bytes: int = 1 << 20
    # Outbound intra-cluster HTTP calls (announce, drain spool push).
    http_request_timeout_s: float = 10.0
    # Serving-edge socket hygiene.
    read_timeout_s: float = 30.0       # slowloris: max time to frame a request
    idle_timeout_s: float = 300.0      # keep-alive connections with no traffic
    write_timeout_s: float = 60.0      # peer stopped draining a response
    max_connections: int = 4096
    blocking_pool_size: int = 16
    # Graceful drain.
    drain_timeout_s: float = 120.0     # worker: max wait for running tasks
    drain_grace_s: float = 0.5         # coordinator: settle time before stop
    spool_finish_timeout_s: float = 30.0
    # Retry-After hint attached to shed responses.
    shed_retry_after_s: float = 1.0
