"""Smoke test of trino_tpu_torch on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printed as it ends (any failure raises and exits non-zero):

1. device: the card's name and power limit, and the time to build every
   CUDA kernel of the port from ``trino_tpu_torch/csrc/``;
2. kernel: the dense group-by kernel against its plain PyTorch version on
   the card over three lane plans at 2^25 rows; the limb totals must be
   equal bit for bit (integer sums: the tolerance is zero). Kernel, plain
   and library-call times are CUDA-event medians of 10 runs;
3. sql: ``select k, sum(v), count(*) ... group by k`` (Q-A) and a filtered
   signed-sum/avg variant (Q-B) over a 2^25-row memory table through
   ``LocalQueryRunner(device="cuda")`` in distributed mode, once cold and
   5 times warm; rows must equal a numpy oracle exactly, and the kernel's
   launch count must rise on every query.

The line before the last is a JSON object with one entry per kernel of
the path; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

ROWS = 1 << 25           # the bench.py headline's table size
KEYS = 4096              # k in [0, 4096)
VBITS = 20               # v in [0, 2^20)
WARM = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nonzero_adds(DG, plan, bins, vals) -> int:
    """The adds this data needs: per lane, the live rows whose limb, sign
    bit or count is nonzero (the kernel skips zero limbs)."""
    live = (bins >= 0) & (bins < plan.G)
    total = 0
    for ci, op in zip(*DG.lane_ops(plan)):
        if op == DG._OP_ZERO:
            continue
        if op == DG._OP_COUNT:
            add = live
        elif op == DG._OP_SIGN:
            add = live & (vals[ci] < 0)
        else:
            add = live & (((vals[ci] >> op) & 255) != 0)
        total += int(add.sum())
    return total


def phase_device():
    import torch

    from trino_tpu_torch import _kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _kernels.build_all()
    build_s = time.perf_counter() - t0
    log(
        "device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, kernel_build_s=round(build_s, 3),
    )
    return smi


def phase_kernel():
    """Kernel vs plain version at the main path's shape (a) and two more
    lane plans; returns the plan (a) measurements for the kernels line."""
    import numpy as np
    import torch

    from trino_tpu_torch.ops import dense_groupby as DG

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    n = ROWS
    plans = {
        "a": (4096, [(True, VBITS)], [False],
              lambda: [rng.integers(0, 1 << VBITS, n)]),
        "b": (128, [(False, 64)], [True],
              lambda: [rng.integers(-(1 << 40), 1 << 40, n)]),
        "c": (8192, [(True, 30), (False, 64), (True, 62)], [False, True, True],
              lambda: [rng.integers(0, 1 << 30, n),
                       rng.integers(-(1 << 40), 1 << 40, n),
                       rng.integers(0, 1 << 62, n)]),
    }
    out = {}
    worst = 0
    for name, (G, cols, pair, make) in plans.items():
        plan = DG.DensePlan(
            G=G, cols=tuple(DG.DenseCol(*c) for c in cols), pair128=tuple(pair)
        )
        bins = torch.from_numpy(rng.integers(0, G, n).astype(np.int32)).to(dev)
        vals = [torch.from_numpy(v.astype(np.int64)).to(dev) for v in make()]
        lt = DG.dense_groupby_device(plan, bins, vals)
        ref = DG.dense_groupby_plain(plan, bins, vals)
        torch.cuda.synchronize()
        err = int((lt - ref).abs().max())
        if not torch.equal(lt, ref):
            raise AssertionError(f"plan {name}: kernel != plain, max |err| {err}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: DG.dense_groupby_cuda(plan, bins, vals))
        plain_ms = cuda_ms(lambda: DG.dense_groupby_plain(plan, bins, vals))
        # least time: each input read once and the (M, 128) int64 output
        # written once at the HBM peak, or this data's nonzero limb adds at
        # the peak rate outside the tensor cores, whichever is larger
        nbytes = bins.numel() * 4 + sum(v.numel() * 8 for v in vals) + plan.m * 128 * 8
        nops = nonzero_adds(DG, plan, bins, vals)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / CUDA_CORE_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        library_ms = None
        if name == "a":
            # yardstick only (never used by the port): one library sum and
            # one library count over the same bins
            v0 = vals[0]

            def library():
                torch.zeros(G, dtype=torch.int64, device=dev).index_add_(0, bins, v0)
                torch.bincount(bins, minlength=G)

            library_ms = cuda_ms(library)
        out[name] = dict(
            G=G, m=plan.m, lanes=plan.lanes, rows=n, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            bytes=nbytes, ops=nops,
            matches_plain=True, max_abs_err=err,
        )
        log("kernel", plan=name, **out[name])
        del bins, vals, lt, ref
    out["max_abs_err"] = worst
    return out


def _oracle(keys, vals_list, sel):
    """Exact per-key integer sums and counts over selected rows: a stable
    sort by key, int64 prefix sums, differences at group boundaries."""
    import numpy as np

    k = keys[sel]
    order = np.argsort(k, kind="stable")
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    uniq = ks[starts]
    counts = np.diff(np.r_[starts, len(ks)])
    sums = []
    for v in vals_list:
        cs = np.r_[0, np.cumsum(v[sel][order], dtype=np.int64)]
        ends = np.r_[starts[1:], len(ks)]
        sums.append(cs[ends] - cs[starts])
    return uniq, sums, counts


def phase_sql():
    import numpy as np
    import torch

    from trino_tpu_torch import _kernels
    from trino_tpu_torch import types as T
    from trino_tpu_torch.columnar import batch_from_numpy
    from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
    from trino_tpu_torch.testing import LocalQueryRunner

    rng = np.random.default_rng(7)
    k = rng.integers(0, KEYS, ROWS)
    v = rng.integers(0, 1 << VBITS, ROWS)
    w = rng.integers(-(1 << 40), 1 << 40, ROWS)
    runner = LocalQueryRunner(device="cuda")
    runner.session.set("execution_mode", "distributed")
    runner.session.set("stream_scan_threshold_rows", 1 << 20)
    mem = runner.catalogs.get("memory")
    mem.create_table(
        "default", "bench_groupby",
        TableSchema("bench_groupby", tuple(
            ColumnSchema(c, T.BIGINT) for c in ("k", "v", "w")
        )),
    )
    mem.insert("default", "bench_groupby", batch_from_numpy([T.BIGINT] * 3, [k, v, w]))

    # oracles
    uk, (sv,), cnt = _oracle(k, [v], np.ones(ROWS, bool))
    want_a = sorted(zip(uk.tolist(), sv.tolist(), cnt.tolist()))
    sel = v < 524288
    uk, (sw, sv2), cnt = _oracle(k, [w, v], sel)
    want_b = sorted(
        zip(uk.tolist(), sw.tolist(), (sv2.astype(np.float64) / cnt).tolist(),
            cnt.tolist())
    )
    queries = {
        "Q-A": ("select k, sum(v), count(*) from memory.default.bench_groupby "
                "group by k", want_a),
        "Q-B": ("select k, sum(w), avg(v), count(*) from "
                "memory.default.bench_groupby where v < 524288 group by k",
                want_b),
    }
    # the main path's run: every count starts at 0 here and is read after
    _kernels.reset_counts()
    report = {}
    for name, (sql, want) in queries.items():
        times = []
        for i in range(1 + WARM):
            before = _kernels.LAUNCHES["dense_groupby"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = runner.engine.execute_statement(sql, runner.session)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if _kernels.LAUNCHES["dense_groupby"] <= before:
                raise AssertionError(f"{name}: the dense kernel did not launch")
            if sorted(res.rows) != want:
                raise AssertionError(f"{name}: rows differ from the numpy oracle")
        warm = statistics.median(times[1:])
        report[name] = dict(
            groups=len(want), cold_ms=times[0], warm_median_ms=warm,
            warm_ms=times[1:], rows_per_s=ROWS / (warm / 1e3),
            fragment_modes={str(f): m for f, m in (res.fragment_modes or {}).items()},
            matches_oracle=True,
        )
        log("sql", query=name, **report[name])
    launches = dict(_kernels.LAUNCHES)
    log("sql", launches=launches)
    phase_profile(runner, {q: sql for q, (sql, _) in queries.items()})
    return launches


def phase_profile(runner, queries) -> None:
    """Where a warm query's time goes: one more warm run of each query
    under torch.profiler, device time by kernel name against the host
    wall time (the device's idle share is 1 - busy / wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for name, sql in queries.items():
        runner.engine.execute_statement(sql, runner.session)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.engine.execute_statement(sql, runner.session)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events (kernels, copies, fills) where the trace has
        # them: the host ops that launched them carry the same time again
        on_device, on_host = [], []
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", 0)
            if dev_us > 0:
                side = getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                (on_device if side else on_host).append(
                    (dev_us / 1e3, e.count, e.key[:60])
                )
        kernels = on_device or on_host
        kernels.sort(reverse=True)
        busy_ms = sum(k[0] for k in kernels)
        log(
            "profile", query=name, events="device" if on_device else "host",
            wall_ms=wall_ms, device_busy_ms=busy_ms,
            device_idle_share=1 - busy_ms / wall_ms if wall_ms else None,
            top=[{"ms": ms, "calls": c, "name": k} for ms, c, k in kernels[:8]],
        )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = phase_device()
    kern = phase_kernel()
    launches = phase_sql()
    a = kern["a"]
    if launches["dense_groupby"] < 1:
        raise AssertionError("the main path launched no dense group-by kernel")
    print(json.dumps({"kernels": [{
        "name": "dense_groupby",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/dense_groupby.cu",
        "replaces": "trino_tpu/ops/dense_groupby.py:229",
        "launches": launches["dense_groupby"],
        "matches_plain": True,
        "max_abs_err": kern["max_abs_err"],
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"],
        "library_ms": a["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
