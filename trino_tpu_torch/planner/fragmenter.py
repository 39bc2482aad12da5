"""Plan fragmenter: split the optimized plan at remote exchanges.

Reference: ``sql/planner/PlanFragmenter.java:88,106`` (createSubPlans cuts
the plan at REMOTE ExchangeNodes into PlanFragments) and
``sql/planner/optimizations/AddExchanges.java:115`` (decides each subtree's
required distribution and inserts the exchanges);
``SystemPartitioningHandle.java:58-66`` names the partitioning handles
(SOURCE / FIXED_HASH / FIXED_BROADCAST / SINGLE).

TPU translation: a fragment is the unit of whole-program compilation — one
pjit/SPMD program over the mesh (SURVEY §7 "Stage = pjit program"). The
partitioning handles map to sharding layouts:

- ``SOURCE``  — rows live where the connector splits were scanned
  (round-robin over mesh shards; Trino's SOURCE_DISTRIBUTION)
- ``HASH``    — rows co-partitioned by key hash (lax.all_to_all shuffle;
  FIXED_HASH_DISTRIBUTION)
- ``SINGLE``  — gathered to one logical partition (final sort/limit/output;
  SINGLE_DISTRIBUTION)

Exchange edges between fragments additionally carry 'broadcast'
(replicate the producer's rows to every shard — FIXED_BROADCAST, used for
the build side of replicated joins).

The aggregation split mirrors the reference's partial/final AggregationNode
steps with accumulator state on the wire (``AggregationNode.Step``,
``AccumulatorStateSerializer``): partial emits per-shard (value, count)
accumulator columns, the hash/single exchange reshuffles them, final
combines.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.planner import plan as P

SOURCE = "SOURCE"
HASH = "HASH"
SINGLE = "SINGLE"


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """Distribution of a subtree's output rows across the mesh."""

    kind: str  # SOURCE | HASH | SINGLE
    keys: tuple[str, ...] = ()  # symbol names, for HASH


@dataclasses.dataclass
class PlanFragment:
    """One fragment = one SPMD program (reference: PlanFragment.java)."""

    id: int
    root: P.PlanNode  # leaves may be RemoteSource nodes
    partitioning: Partitioning  # where this fragment's work runs
    # how this fragment's output ships to its consumer (None for the root
    # fragment, whose output goes to the client):
    output_exchange: Optional[str] = None  # 'hash' | 'broadcast' | 'single'
    output_keys: list[P.Symbol] = dataclasses.field(default_factory=list)

    @property
    def source_fragment_ids(self) -> list[int]:
        return [
            n.fragment_id
            for n in P.walk_plan(self.root)
            if isinstance(n, P.RemoteSource)
        ]


@dataclasses.dataclass
class SubPlan:
    """Fragment tree, root fragment first (reference: SubPlan.java)."""

    fragment: PlanFragment
    children: list["SubPlan"] = dataclasses.field(default_factory=list)

    def all_fragments(self) -> list[PlanFragment]:
        out = [self.fragment]
        for c in self.children:
            out.extend(c.all_fragments())
        return out


def fragment_plan(root: P.PlanNode, session=None) -> SubPlan:
    """AddExchanges + createSubPlans: the full fragmentation pipeline."""
    from trino_tpu_torch.planner.sanity import PlanSanityChecker, validation_enabled

    with_exchanges, _ = _add_exchanges(root)
    sub = _split(with_exchanges)
    if validation_enabled(session):
        PlanSanityChecker.validate_fragments(sub)
    return sub


# === AddExchanges ===========================================================


def _hash_compatible(part: Partitioning, keys: list[P.Symbol]) -> bool:
    return part.kind == HASH and part.keys == tuple(s.name for s in keys)


def _gather(node: P.PlanNode, part: Partitioning) -> P.PlanNode:
    """Insert a SINGLE exchange unless already single."""
    if part.kind == SINGLE:
        return node
    return P.Exchange(node, "single", [], scope="remote")


def _add_exchanges(node: P.PlanNode) -> tuple[P.PlanNode, Partitioning]:
    """Recursive AddExchanges: returns (rewritten node, output partitioning)."""
    if isinstance(node, P.TableScan):
        return node, Partitioning(SOURCE)
    if isinstance(node, P.Values):
        return node, Partitioning(SINGLE)

    if isinstance(node, (P.Filter, P.Project, P.GroupId, P.Unnest)):
        src, part = _add_exchanges(node.source)
        node = dataclasses.replace(node, source=src)
        return node, part

    if isinstance(node, P.Aggregate):
        return _add_exchanges_aggregate(node)

    if isinstance(node, P.Join):
        return _add_exchanges_join(node)

    if isinstance(node, P.Distinct):
        src, part = _add_exchanges(node.source)
        # v1: gathered distinct (hash-partitioned partial/final later)
        return P.Distinct(_gather(src, part)), Partitioning(SINGLE)

    if isinstance(node, P.Sort):
        src, part = _add_exchanges(node.source)
        return P.Sort(_gather(src, part), node.order_by), Partitioning(SINGLE)

    if isinstance(node, P.TopN):
        src, part = _add_exchanges(node.source)
        if part.kind == SINGLE:
            return P.TopN(src, node.count, node.order_by), Partitioning(SINGLE)
        # partial per shard, gather, final (reference: TopNNode partial/final)
        partial = P.TopN(src, node.count, node.order_by, step="partial")
        gathered = _gather(partial, part)
        return (
            P.TopN(gathered, node.count, node.order_by, step="final"),
            Partitioning(SINGLE),
        )

    if isinstance(node, P.Limit):
        src, part = _add_exchanges(node.source)
        if part.kind == SINGLE:
            return dataclasses.replace(node, source=src), Partitioning(SINGLE)
        if node.offset or node.count is None:
            # OFFSET needs global row order — gather first
            return (
                dataclasses.replace(node, source=_gather(src, part)),
                Partitioning(SINGLE),
            )
        partial = P.Limit(src, node.count)
        gathered = _gather(partial, part)
        return P.Limit(gathered, node.count), Partitioning(SINGLE)

    if isinstance(node, P.Window):
        src, part = _add_exchanges(node.source)
        # v1: gathered window (hash-by-partition-keys later)
        return (
            dataclasses.replace(node, source=_gather(src, part)),
            Partitioning(SINGLE),
        )

    if isinstance(node, P.SetOp):
        inputs = []
        for child in node.inputs:
            src, part = _add_exchanges(child)
            inputs.append(_gather(src, part))
        return dataclasses.replace(node, inputs=inputs), Partitioning(SINGLE)

    if isinstance(node, P.Output):
        src, part = _add_exchanges(node.source)
        return (
            dataclasses.replace(node, source=_gather(src, part)),
            Partitioning(SINGLE),
        )

    if isinstance(node, P.Exchange):  # already placed (idempotence)
        src, _ = _add_exchanges(node.source)
        out_part = (
            Partitioning(HASH, tuple(s.name for s in node.keys))
            if node.partitioning == "hash"
            else Partitioning(SINGLE)
        )
        return dataclasses.replace(node, source=src), out_part

    # unknown node kinds execute wherever their child lives
    if node.sources:
        srcs = [_add_exchanges(s) for s in node.sources]
        return node, srcs[0][1]
    return node, Partitioning(SINGLE)


def _add_exchanges_aggregate(node: P.Aggregate) -> tuple[P.PlanNode, Partitioning]:
    src, part = _add_exchanges(node.source)
    if part.kind == SINGLE or node.step != "single":
        return dataclasses.replace(node, source=src), part
    if any(
        fn.distinct or fn.kind == "array_agg" for _, fn in node.aggregates
    ):
        # DISTINCT / array_agg need a global view of values — gather
        # (reference uses MarkDistinct + hash exchanges; v1 gathers)
        return (
            dataclasses.replace(node, source=_gather(src, part)),
            Partitioning(SINGLE),
        )
    acc = _make_acc_symbols(node)
    partial = P.Aggregate(
        src, node.group_keys, node.aggregates, step="partial", acc_symbols=acc
    )
    if node.group_keys:
        ex = P.Exchange(partial, "hash", list(node.group_keys), scope="remote")
        final = P.Aggregate(
            ex, node.group_keys, node.aggregates, step="final", acc_symbols=acc
        )
        return final, Partitioning(HASH, tuple(s.name for s in node.group_keys))
    ex = P.Exchange(partial, "single", [], scope="remote")
    final = P.Aggregate(
        ex, node.group_keys, node.aggregates, step="final", acc_symbols=acc
    )
    return final, Partitioning(SINGLE)


def _make_acc_symbols(
    node: P.Aggregate,
) -> list[tuple[P.Symbol, Optional[P.Symbol]]]:
    acc = []
    for sym, fn in node.aggregates:
        if fn.kind in ("count", "count_star"):
            acc.append((P.Symbol(P.fresh_name(f"{sym.name}_acc"), T.BIGINT), None))
        else:
            # value column keeps the input/result representation; count
            # column carries non-null cardinality (NULL and avg semantics)
            vt = fn.result_type if fn.kind in ("sum", "avg") else (
                fn.argument.type if fn.argument is not None else fn.result_type
            )
            acc.append(
                (
                    P.Symbol(P.fresh_name(f"{sym.name}_acc"), vt),
                    P.Symbol(P.fresh_name(f"{sym.name}_cnt"), T.BIGINT),
                )
            )
    return acc


def _add_exchanges_join(node: P.Join) -> tuple[P.PlanNode, Partitioning]:
    left, lpart = _add_exchanges(node.left)
    right, rpart = _add_exchanges(node.right)

    if node.join_type == "CROSS" and node.single_row:
        # uncorrelated scalar subquery: broadcast the one-row build so
        # the probe keeps its partitioning (the scalar is an all_gather
        # away on every shard)
        bcast = P.Exchange(right, "broadcast", [], scope="remote")
        return dataclasses.replace(node, left=left, right=bcast), lpart
    gather_kinds = ("CROSS", "SEMI", "ANTI", "RIGHT", "FULL")
    if (
        node.join_type in gather_kinds
        or (node.single_row and node.join_type != "LEFT")
        or not node.criteria
        or (node.join_type == "LEFT" and node.filter is not None)
    ):
        # kinds the SPMD join kernels do not cover yet run gathered
        # (mirrors DistributedExecutor's fallback set)
        return (
            dataclasses.replace(
                node, left=_gather(left, lpart), right=_gather(right, rpart)
            ),
            Partitioning(SINGLE),
        )

    lkeys = [a for a, _ in node.criteria]
    rkeys = [b for _, b in node.criteria]
    if node.distribution == "replicated":
        # probe side stays put; build side replicates to every shard
        bcast = P.Exchange(right, "broadcast", [], scope="remote")
        return dataclasses.replace(node, right=bcast), lpart
    # partitioned: co-partition both sides on the join keys
    if not _hash_compatible(lpart, lkeys):
        left = P.Exchange(left, "hash", lkeys, scope="remote")
    if not _hash_compatible(rpart, rkeys):
        right = P.Exchange(right, "hash", rkeys, scope="remote")
    return (
        dataclasses.replace(node, left=left, right=right),
        Partitioning(HASH, tuple(s.name for s in lkeys)),
    )


# === createSubPlans =========================================================


def _split(root: P.PlanNode) -> SubPlan:
    """Cut at remote Exchange nodes (reference: Fragmenter visitor)."""
    counter = itertools.count(1)
    children_of: dict[int, list[SubPlan]] = {}

    def cut(node: P.PlanNode, current: int) -> P.PlanNode:
        if isinstance(node, P.Exchange) and node.scope == "remote":
            fid = next(counter)
            child_root = cut(node.source, fid)
            frag = PlanFragment(
                fid,
                child_root,
                _fragment_partitioning(child_root),
                output_exchange=node.partitioning,
                output_keys=list(node.keys),
            )
            children_of.setdefault(current, []).append(
                SubPlan(frag, children_of.get(fid, []))
            )
            return P.RemoteSource(
                fid,
                list(node.output_symbols),
                exchange_type=node.partitioning,
                keys=list(node.keys),
            )
        replacements = {}
        for name, value in vars(node).items():
            if isinstance(value, P.PlanNode):
                replacements[name] = cut(value, current)
            elif isinstance(value, list) and value and isinstance(value[0], P.PlanNode):
                replacements[name] = [cut(v, current) for v in value]
        if replacements:
            node = dataclasses.replace(node, **replacements)
        return node

    root_cut = cut(root, 0)
    frag0 = PlanFragment(0, root_cut, _fragment_partitioning(root_cut))
    return SubPlan(frag0, children_of.get(0, []))


def _fragment_partitioning(root: P.PlanNode) -> Partitioning:
    """A fragment runs where its leaves put it: scans → SOURCE, hash
    remote-sources → HASH, otherwise SINGLE."""
    hash_keys: tuple[str, ...] = ()
    kind = SINGLE
    for n in P.walk_plan(root):
        if isinstance(n, P.TableScan):
            return Partitioning(SOURCE)
        if isinstance(n, P.RemoteSource) and n.exchange_type == "hash":
            kind = HASH
            hash_keys = tuple(s.name for s in n.keys)
    return Partitioning(kind, hash_keys)


# === whole-pipeline fusion ==================================================


@dataclasses.dataclass
class FusedFragment:
    """A chain/tree of exchange-connected fragments compiled as ONE
    program: interior HASH (or gather) exchanges become in-jit
    collectives instead of fragment boundaries, so the whole group costs
    a single dispatch round-trip. ``fragments`` is in bottom-up execution
    order — producers first, the consumer root LAST (the root's output
    exchange is the unit's output exchange)."""

    fragments: tuple[PlanFragment, ...]

    @property
    def root(self) -> PlanFragment:
        return self.fragments[-1]

    @property
    def id(self) -> int:
        return self.fragments[-1].id

    @property
    def fragment_ids(self) -> tuple[int, ...]:
        return tuple(f.id for f in self.fragments)

    @property
    def member_ids(self) -> frozenset:
        return frozenset(f.id for f in self.fragments)

    @property
    def external_source_ids(self) -> tuple[int, ...]:
        """Source fragment ids the unit pulls from OUTSIDE itself — the
        unit's recovery lineage. Interior links are in-jit collectives
        with no retained pages, so healing a unit means healing exactly
        these (each is itself a unit root or a plain fragment: a
        fragment tree has a single consumer per exchange, so an external
        producer can never be the interior of another unit)."""
        inside = self.member_ids
        out: list[int] = []
        for f in self.fragments:
            for fid in f.source_fragment_ids:
                if fid not in inside and fid not in out:
                    out.append(fid)
        return tuple(out)


def partitioned_join_pairs(sub) -> list[tuple[int, int]]:
    """(probe_fid, build_fid) producer pairs of every partitioned
    hash/hash equi-join (the skew-role pairing — mirrors
    ``FragmentedExecutor._skew_roles``). The fusion pass keeps each pair
    in the same unit or out of fusion entirely: the probe exchange
    detects heavy hitters and the build exchange salts with the
    resulting hot set, so splitting a pair across a fusion boundary
    would break their ordering/co-partitioning contract.

    ``sub`` is a :class:`SubPlan` or a bare fragment iterable (workers
    hold only the shipped member list, never the SubPlan)."""
    pairs: list[tuple[int, int]] = []
    frags = sub.all_fragments() if isinstance(sub, SubPlan) else sub
    for frag in frags:
        for node in P.walk_plan(frag.root):
            if (
                isinstance(node, P.Join)
                and node.join_type in ("INNER", "LEFT")
                and node.criteria
                and not node.single_row
                and isinstance(node.left, P.RemoteSource)
                and node.left.exchange_type == "hash"
                and isinstance(node.right, P.RemoteSource)
                and node.right.exchange_type == "hash"
            ):
                pairs.append(
                    (node.left.fragment_id, node.right.fragment_id)
                )
    return pairs


def filtered_broadcast_fids(sub) -> set[int]:
    """Fragment ids of broadcast producers carrying a selective Filter.

    Absorbing such a build into its consumer's fused unit (the
    ``broadcast_links`` star-join path) would erase the dynamic-filter
    boundary: worker-side DF prunes probe splits/rows from a
    *materialized* build, and a fused interior member never
    materializes. A selective dim build is exactly where DF pays more
    than the saved dispatch round-trip, so callers keep these links
    unfused when dynamic filtering is enabled; predicate-free dim
    builds (full-domain DF, nothing to prune) still fuse."""
    fids: set[int] = set()
    frags = sub.all_fragments() if isinstance(sub, SubPlan) else sub
    for frag in frags:
        if frag.output_exchange != "broadcast":
            continue
        if any(isinstance(n, P.Filter) for n in P.walk_plan(frag.root)):
            fids.add(frag.id)
    return fids


def fuse_groups(
    sub: SubPlan,
    *,
    fusable,
    max_fragments: int = 8,
    blocked: frozenset = frozenset(),
    skew_pairs=(),
    include_root: bool = True,
    broadcast_links: bool = False,
):
    """Post-fragmentation grouping: partition the fragment tree into
    fused units. Returns a list of units in bottom-up execution order;
    each unit is either a plain :class:`PlanFragment` (unfused) or a
    :class:`FusedFragment` of 2+ members.

    A producer fuses into its consumer's unit when every leg of the link
    is eligible:

    - both sides trace (``fusable(frag)`` — the exec layer passes
      ``fragment_fusable``) and neither is in ``blocked`` (the caller
      blocks spill-sized / streaming-eligible fragments, and cluster
      callers block spool-required boundaries);
    - the connecting exchange is plain or skew-salted HASH, or a gather
      ('single' — e.g. into a final global aggregation). Broadcast links
      stay fragment boundaries unless ``broadcast_links`` is set (the
      dense join tier): then REPLICATE/broadcast dim builds ride inside
      their consumer's unit, so a star-join fact chain probes every dim
      in ONE fused program instead of pairwise join fragments;
    - skew-paired producers (``skew_pairs``) are absorbed atomically —
      both or neither;
    - the unit stays within ``max_fragments`` members.

    Grouping is greedy consumer-down: a consumer claims its eligible
    producers, and claimed producers extend the same unit with their own
    producers transitively. ``include_root=False`` keeps the root
    fragment (coordinator-executed in cluster mode) out of any unit.
    """
    order: list[PlanFragment] = []
    children: dict[int, list[PlanFragment]] = {}

    def visit(sp: SubPlan) -> None:
        children[sp.fragment.id] = [c.fragment for c in sp.children]
        for c in sp.children:
            visit(c)
        order.append(sp.fragment)

    visit(sub)
    peer: dict[int, int] = {}
    for a, b in skew_pairs:
        peer[a] = b
        peer[b] = a
    max_fragments = max(1, int(max_fragments))
    links = (
        ("hash", "single", "broadcast")
        if broadcast_links
        else ("hash", "single")
    )
    ok = {
        f.id
        for f in order
        if f.id not in blocked and fusable(f)
    }
    owner: dict[int, int] = {}  # fid -> unit-root fid
    size: dict[int, int] = {}
    for frag in reversed(order):  # consumers before their producers
        if frag.id not in ok:
            continue
        if frag.id == sub.fragment.id and not include_root:
            continue
        ru = owner.setdefault(frag.id, frag.id)
        size.setdefault(ru, 1)
        kids = children.get(frag.id, [])
        kid_ids = {k.id for k in kids}
        claimed: set[int] = set()
        for child in kids:
            if child.id in claimed:
                continue
            group = [child]
            mate = peer.get(child.id)
            if mate is not None:
                if mate not in kid_ids:
                    continue  # pair split across consumers: stay unfused
                group.append(next(k for k in kids if k.id == mate))
            claimed.update(c.id for c in group)
            if any(c.id not in ok for c in group):
                continue
            if any(c.output_exchange not in links for c in group):
                continue
            if size[ru] + len(group) > max_fragments:
                continue
            for c in group:
                owner[c.id] = ru
            size[ru] += len(group)
    units: list = []
    for frag in order:
        if owner.get(frag.id, frag.id) != frag.id:
            continue  # interior member; emitted with its unit root
        members = [f for f in order if owner.get(f.id, f.id) == frag.id]
        units.append(
            FusedFragment(tuple(members)) if len(members) > 1 else frag
        )
    return units


# === EXPLAIN rendering ======================================================


def subplan_text(subplan: SubPlan) -> str:
    """Fragment-structured EXPLAIN (reference: PlanPrinter.textDistributedPlan)."""
    lines = []
    for frag in sorted(subplan.all_fragments(), key=lambda f: f.id):
        head = f"Fragment {frag.id} [{frag.partitioning.kind}"
        if frag.partitioning.keys:
            head += "(" + ", ".join(frag.partitioning.keys) + ")"
        head += "]"
        if frag.output_exchange:
            head += f" -> {frag.output_exchange}"
            if frag.output_keys:
                head += "(" + ", ".join(s.name for s in frag.output_keys) + ")"
        lines.append(head)
        lines.append(P.plan_text(frag.root, indent=1))
        lines.append("")
    return "\n".join(lines).rstrip()
