"""Plan serde and canonicalization in the port
(``planner/serde.py``, ``planner/canonicalize.py``) against the
reference's, over the TPC-H 22 and the TPC-DS corpus at ``tiny``: the
optimized plan's JSON (symbol counters renamed positionally, as the
fingerprint renames them) equal in both packages; the fingerprint and
the hoisted-parameter list of ``canonicalize_plan(..., mesh_devices=1)``
equal; ``fragment_from_json(fragment_to_json(f))`` a round trip through
the port's sanity checks; and the maintainability classification equal.

One difference is named: the session default of
``stream_device_chunk_rows``, a codegen property, is None in the port
(its device chunks are sized by the card's free memory when it is
unset) and 2^21 in the reference. The port's sessions here carry the
reference's value, so the fingerprints compare; with the default they
differ in that property only (``test_codegen_props``).
"""

import pytest
import torch

from trino_tpu.planner import canonicalize as RC
from trino_tpu.planner import serde as RS
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch.benchmarks.tpcds import queries as tpcds
from trino_tpu_torch.benchmarks.tpch import queries as tpch
from trino_tpu_torch.planner import canonicalize as C
from trino_tpu_torch.planner import serde as S
from trino_tpu_torch.planner.fragmenter import fragment_plan
from trino_tpu_torch.testing import LocalQueryRunner

torch.set_num_threads(1)

CORPUS = {f"tpch-q{q}": sql for q, sql in tpch("tpch.tiny").items()}
CORPUS.update({f"tpcds-q{q}": sql for q, sql in tpcds("tpcds.tiny").items()})

@pytest.fixture(scope="module")
def runners():
    ref, port = RefRunner(), LocalQueryRunner(device="cpu")
    for r in (ref, port):
        r.session.set("execution_mode", "distributed")
    port.session.set("stream_device_chunk_rows", ref.session.get("stream_device_chunk_rows"))
    return ref, port


def test_codegen_props(runners):
    """The list is the reference's; a port session with its own defaults
    differs from the reference's in ``stream_device_chunk_rows`` only."""
    assert C._CODEGEN_PROPS == RC._CODEGEN_PROPS
    ref, _ = runners
    fresh = LocalQueryRunner(device="cpu")
    fresh.session.set("execution_mode", "distributed")
    differ = [p for p in C._CODEGEN_PROPS
              if repr(fresh.session.get(p)) != repr(ref.session.get(p))]
    assert differ == ["stream_device_chunk_rows"]


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_plan_json_and_fingerprint_equal_the_reference(runners, name):
    ref, port = runners
    sql = CORPUS[name]
    rplan, pplan = ref.plan(sql), port.plan(sql)
    assert C._alpha_rename(S.node_to_json(pplan), {}) == RC._alpha_rename(
        RS.node_to_json(rplan), {})
    rroot, rparams, rfp = RC.canonicalize_plan(rplan, ref.session, 1)
    proot, pparams, pfp = C.canonicalize_plan(pplan, port.session, 1)
    assert pfp == rfp
    assert [(v, str(t)) for v, t in pparams] == [(v, str(t)) for v, t in rparams]
    assert C._alpha_rename(S.node_to_json(proot), {}) == RC._alpha_rename(
        RS.node_to_json(rroot), {})
    assert C.classify_maintainability(pplan) == RC.classify_maintainability(rplan)
    # binding the parameters back gives the optimized plan's JSON
    assert S.node_to_json(C.bind_params(proot, pparams)) == S.node_to_json(
        C._strip_scan_constraints(pplan) if pparams else pplan)


@pytest.mark.parametrize("name", [n for n in sorted(CORPUS) if n.startswith("tpch")])
def test_fragment_serde_round_trips(runners, name):
    _, port = runners
    sub = fragment_plan(port.plan(CORPUS[name]), port.session)
    for frag in sub.all_fragments():
        doc = S.fragment_to_json(frag)
        again = S.fragment_from_json(doc, validate=True)
        assert S.fragment_to_json(again) == doc
