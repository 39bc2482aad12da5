"""The port's host-read lint (``trino_tpu_torch/lint/jit_safety.py``): the
package must stay clean relative to the port's own suppression baseline,
and each torch rule must fire on a seeded bad pattern and stay quiet on
its corrected version (the cases of ``tests/test_lint.py``, on torch)."""

import json
import os
import textwrap

from trino_tpu_torch.lint import (
    compare_to_baseline,
    lint_all,
    lint_paths,
    load_baseline,
    main,
)
from trino_tpu_torch.lint import jit_safety

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint_source(tmp_path, source: str):
    mod = tmp_path / "seeded.py"
    mod.write_text(textwrap.dedent(source))
    return lint_paths([mod])


def _rules(violations):
    return {v.rule for v in violations}


def test_repo_is_clean_against_baseline():
    """CI gate: the whole package, new host-read violations only."""
    violations = lint_paths(["trino_tpu_torch"])
    new, _stale = compare_to_baseline(violations, load_baseline())
    assert not new, "new host-read violations:\n" + "\n".join(
        v.render() for v in new
    )


def test_cli_exit_codes(tmp_path):
    assert main(["--only", "jit", "trino_tpu_torch"]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import torch\n"
        "def f(x: torch.Tensor):\n"
        "    return float(torch.sum(x))\n"
    )
    assert main([str(bad)]) != 0


def test_host_roundtrip_item(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import torch
        def f(x: torch.Tensor):
            return x.sum().item()
        """,
    )
    assert "JIT001" in _rules(vs)


def test_host_cast_on_torch(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import torch
        def f(x):
            return int(torch.max(x))
        """,
    )
    assert "JIT002" in _rules(vs)


def test_branch_on_tensor_value(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import torch
        def f(x):
            if torch.any(x > 0):
                return x
            return -x
        """,
    )
    assert "JIT003" in _rules(vs)


def test_branch_on_static_dtype_predicate_is_fine(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import torch
        def f(x: torch.Tensor):
            if torch.is_floating_point(x):
                return x
            if x.dtype == torch.float64 or x.shape[0] == 0 or x.numel() > 4:
                return x
            if x.dim() == 1 and x.is_cuda:
                return x
            return x.to(torch.float32)
        """,
    )
    assert "JIT003" not in _rules(vs)


def test_float_literal_narrowing(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import torch
        def f():
            return torch.tensor([0.5, 1.5])
        """,
    )
    assert "JIT004" in _rules(vs)


def test_float_literal_with_dtype_is_fine(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import torch
        def f():
            return torch.tensor([0.5, 1.5], dtype=torch.float64)
        """,
    )
    assert "JIT004" not in _rules(vs)


def test_set_iteration_order(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import torch
        def f(parts):
            return torch.cat([parts[k] for k in set(parts)])
        """,
    )
    assert "JIT005" in _rules(vs)


def test_sorted_set_iteration_is_fine(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import torch
        def f(parts):
            return torch.cat([parts[k] for k in sorted(set(parts))])
        """,
    )
    assert "JIT005" not in _rules(vs)


def test_np_compute_on_tensor(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import numpy as np
        import torch
        def f(x):
            y = torch.cumsum(x, 0)
            return np.argsort(y)
        """,
    )
    assert "JIT006" in _rules(vs)


def test_np_in_pure_host_function_is_fine(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import numpy as np
        import torch
        def f(x):
            y = torch.cumsum(x, 0).cpu().numpy()  # lint: ignore[JIT001]
            return np.argsort(y), np.argsort(x)
        """,
    )
    assert "JIT006" not in _rules(vs)


def test_host_pull_between_fragment_dispatches(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        def drive(executor, frag_a, frag_b, inputs, layouts):
            a = executor.run_fragment_program(frag_a, inputs, layouts)
            rows = a.batch.to_host()  # dead under fusion: boundary is in-program
            return executor.run_fragment_program(frag_b, {"remote": rows}, layouts)
        """,
    )
    assert "JIT007" in _rules(vs)


def test_host_pull_after_last_dispatch_is_fine(tmp_path):
    # pulling the ROOT result after the final dispatch is the normal
    # materialization step, not an inter-fragment sync
    vs = _lint_source(
        tmp_path,
        """
        def drive(executor, frag, inputs, layouts):
            res = executor.run_fused_program([frag], inputs, layouts)
            return res.batch.to_host()
        """,
    )
    assert "JIT007" not in _rules(vs)


def test_host_pull_in_nested_scope_is_fine(tmp_path):
    # the dispatch-loop shape: dispatches live in a nested def, the packed
    # root pull in the parent — separate scopes, no violation
    vs = _lint_source(
        tmp_path,
        """
        def drive(executor, units, inputs, layouts):
            results = {}
            def run_units():
                for u in units:
                    results[u.id] = executor.run_fragment_program(u, inputs, layouts)
            run_units()
            root = results[max(results)]
            final = root.batch.to_host()
            run_units()
            return final
        """,
    )
    assert "JIT007" not in _rules(vs)


def test_batch_demux_pull_is_allowlisted(tmp_path):
    # the batch replay pulls the K members' words in one read between
    # dispatches BY DESIGN — the same shape under any other name is
    # still a violation
    src = """
        def {name}(executor, frag_a, frag_b, inputs, layouts):
            a = executor.execute_batched(frag_a, inputs)
            rows = a.batch.to_host()
            return executor.execute_batched(frag_b, {{"remote": rows}})
        """
    flagged = _lint_source(tmp_path, src.format(name="drive_batch"))
    assert "JIT007" in _rules(flagged)
    allowed = _lint_source(tmp_path, src.format(name="_replay_batch"))
    assert "JIT007" not in _rules(allowed)


def test_inline_suppression_comment(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import torch
        def f(x: torch.Tensor):
            return x.sum().item()  # lint: ignore[JIT001]
        """,
    )
    assert "JIT001" not in _rules(vs)


def test_baseline_comparison_counts(tmp_path):
    vs = _lint_source(
        tmp_path,
        """
        import torch
        def f(x: torch.Tensor):
            a = x.sum().item()
            b = x.max().item()
            return a, b
        """,
    )
    only_jit1 = [v for v in vs if v.rule == "JIT001"]
    assert len(only_jit1) == 2
    baseline = {"version": 1, "entries": {only_jit1[0].key: 1}}
    new, stale = compare_to_baseline(only_jit1, baseline)
    assert len(new) == 1  # one allowed, one new
    assert not stale


# === what the torch rules add =================================================


def test_allow_sync_and_numpy_reads_are_quiet(tmp_path):
    """A counted read inside ``allow_sync`` and ``.item()`` on a numpy
    value (the reference's five findings in ``connectors/api.py`` and
    ``dynfilter.py``) do not fire; ``.cpu()`` fires on any receiver, a
    chain of reads once, and a data-dependent call on a tensor."""
    vs = _lint_source(
        tmp_path,
        """
        import numpy as np
        import torch
        from trino_tpu_torch.exec.programs import allow_sync

        def counted(x: torch.Tensor):
            with allow_sync(x.device):
                return x.cpu().tolist(), int(x.max()), x.nonzero()

        def host(values):
            uniq = np.unique(values)
            live = np.asarray(values)
            return [v.item() for v in uniq], uniq[0].item(), live.min().item()

        def unknown(col):
            return col.data.cpu().numpy()

        def dependent(mask: torch.Tensor):
            return torch.nonzero(mask), mask.unique()
        """,
    )
    by_fn = {}
    for v in vs:
        by_fn.setdefault(v.func, []).append(v.rule)
    assert "counted" not in by_fn and "host" not in by_fn, by_fn
    assert by_fn["unknown"] == ["JIT001"]
    assert by_fn["dependent"] == ["JIT001", "JIT001"]


def test_host_read_names_cover_the_capture_guard():
    """Every member of ``exec/programs.py::_HOST_READS`` (what a capture
    refuses) is a host read some rule finds."""
    from trino_tpu_torch.exec import programs

    names = {f.__name__ for f in programs._HOST_READS}
    assert names <= set(jit_safety.HOST_READ_NAMES), names - set(jit_safety.HOST_READ_NAMES)
    assert set(jit_safety.HOST_READ_NAMES.values()) == {"JIT001", "JIT002", "JIT003"}


def test_dispatch_names_are_the_ports():
    """The JIT007 dispatch and demux names are functions of the port."""
    import ast
    from pathlib import Path

    defined = set()
    for path in sorted(Path(REPO, "trino_tpu_torch").rglob("*.py")):
        _, tree = jit_safety.parse_file(path)
        defined |= {n.name for n in ast.walk(tree)
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert jit_safety._FRAGMENT_DISPATCH <= defined, jit_safety._FRAGMENT_DISPATCH - defined
    assert jit_safety._JIT007_DEMUX_ALLOWED <= jit_safety._FRAGMENT_DISPATCH


def test_port_gate_every_family_and_every_entry_noted():
    """The port's gate: ``lint_all(["trino_tpu_torch"])`` has no violation
    outside the port's baseline, the baseline has no stale entry, and
    every entry has a written justification."""
    baseline = load_baseline()
    new, stale = compare_to_baseline(lint_all(["trino_tpu_torch"]), baseline)
    assert not new, "\n".join(v.render() for v in new)
    assert not stale, stale
    assert all(k.startswith("trino_tpu_torch/") for k in baseline["entries"])
    notes = baseline["notes"]
    assert set(notes) == set(baseline["entries"])
    assert all(isinstance(n, str) and len(n) > 40 for n in notes.values())
    with open(jit_safety.BASELINE_PATH) as f:
        assert json.load(f) == baseline
