"""AST lint for host synchronization in the port's torch code.

A CUDA tensor lives on the card; several ordinary Python idioms read it
from the host, which blocks the stream, stalls the card, and cannot be
recorded into a CUDA graph (``exec/programs.py`` captures a fragment's
device work as one):

- ``JIT001`` host read — ``.item()``, ``.tolist()``, ``.cpu()`` or
  ``.numpy()`` on a torch expression, and the data-dependent calls of
  ``HostReadGuard``'s list (``nonzero``, ``unique``, ``masked_select``,
  ``argwhere``, ``bincount``). A read inside ``with allow_sync(...)`` is a
  counted read (``exec/programs.py``) and does not fire.
- ``JIT002`` host cast — ``int()``/``float()``/``bool()`` (and
  ``range()``) on a torch expression read it through ``__int__``,
  ``__float__``, ``__bool__`` or ``__index__``.
- ``JIT003`` tensor branch — Python ``if``/``while`` on a torch
  expression reads its truth value from the card. Shape, dtype and device
  predicates (``.shape``, ``.dtype ==``, ``.numel()``, ``.dim()``,
  ``.is_cuda``, ``torch.is_floating_point``) are static and do not fire.
- ``JIT004`` float-literal narrowing — ``torch.tensor(0.5)`` and friends
  without ``dtype=`` make float32 under torch's default dtype, which
  narrows a DOUBLE; DOUBLE results must be bit-identical to the JAX
  reference.
- ``JIT005`` unordered iteration — iterating a ``set`` to build a
  concat/collective operand order is nondeterministic across processes
  (hash randomization), which mis-orders shards and exchanges.
- ``JIT006`` numpy on a tensor — an ``np.*`` compute call over a torch
  expression copies it to the host through ``__array__``.
- ``JIT007`` inter-fragment host pull — a ``to_host``/``host_read`` or
  a host read of a torch expression followed by another fragment dispatch
  in the same function. With pipeline fusion the interior fragment
  boundary lives inside one program, so the pull is a dead device→host
  round trip; keep the value on the card and let the program chain it.

A torch expression is a value made by a ``torch.*`` call or a tensor
method, or a parameter annotated ``torch.Tensor``, tracked per function
in source order; a value made by ``np.*`` (or ``.numpy()``) is a numpy
value, and ``.item()``/``.tolist()`` on it is no device read. Since
numpy has no ``.cpu()`` or ``.numpy()``, those fire on any receiver. The
lint cannot tell a host tensor from a CUDA one: a read of a host tensor
fires too, and is baselined with its reason.

Violations are keyed against a checked-in suppression baseline
(``baseline.json``) so CI fails only on *new* violations. A line comment
``# lint: ignore[JIT00x]`` suppresses a single finding at source level.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import json
import sys
from pathlib import Path
from typing import Iterable, Optional

REPO_ROOT = Path(__file__).resolve().parents[2]
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"

# the whole package; the kernel-heavy dirs (ops/, exec/, parallel/) are
# where the rules bite, but host-side modules get the same scan
DEFAULT_PATHS = ("trino_tpu_torch",)

RULES = {
    "JIT001": "host read: .item()/.tolist()/.cpu()/.numpy() or a data-dependent "
    "call syncs the card outside allow_sync",
    "JIT002": "host cast: int()/float()/bool() on a torch expression syncs the card",
    "JIT003": "python branch on a torch expression (if/while) reads its truth value",
    "JIT004": "float literal constructor without dtype= makes float32, narrowing a DOUBLE",
    "JIT005": "iteration over an unordered set feeds collective/concat order",
    "JIT006": "np.* compute on a torch expression copies it to the host (__array__)",
    "JIT007": "host pull (to_host/host_read/.item()) before a later fragment dispatch: "
    "fusion keeps the boundary in one program, making the sync dead",
}

# tensor methods that copy to the host
_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# data-dependent calls: their output's shape is read from the card
_DATA_DEPENDENT = frozenset(
    {"nonzero", "unique", "unique_consecutive", "masked_select", "argwhere", "bincount"}
)
# casts to a Python number or truth value
_CASTS = frozenset({"int", "float", "bool", "range"})

# the host-read functions of ``exec/programs.py::_HOST_READS`` by name,
# each with the rule that finds it
HOST_READ_NAMES = {
    **{name: "JIT001" for name in _READ_METHODS | _DATA_DEPENDENT},
    "__int__": "JIT002", "__float__": "JIT002", "__index__": "JIT002",
    "__bool__": "JIT003",
}

# entry points that dispatch a fragment program (or a fused chain of
# them) to the device — a host pull lexically before one of these in the
# same function straddles a fragment boundary fusion can keep on device
_FRAGMENT_DISPATCH = frozenset(
    {
        "run_fragment_program",
        "run_fused_program",
        "run_chain",
        "_run_fragment",
        "_run_fused_unit",
        "_run_fused_spanned",
        # the batched forms (exec/fragments.py, engine.py, exec/batching.py)
        "execute_batched",
        "_replay_batch",
        "_execute_query_plan_batched",
        "_run_batched",
    }
)

# functions where a host pull before a later dispatch is the POINT: the
# cross-query batch demux pulls all K members' words in one packed read
# after the replays, and the batch loop runs the next unit after it —
# that pull/dispatch interleaving is the protocol, not a dead sync
_JIT007_DEMUX_ALLOWED = frozenset(
    {
        "_replay_batch",
        "execute_batched",
    }
)

# np.* attrs that compute over array *values* (vs constructors/dtype meta,
# which are legitimate host-side prep even in device code)
_NP_COMPUTE = frozenset(
    {
        "sum", "mean", "prod", "cumsum", "cumprod", "dot", "matmul",
        "where", "nonzero", "flatnonzero", "argsort", "sort", "unique",
        "concatenate", "stack", "vstack", "hstack", "split", "take",
        "searchsorted", "bincount", "add", "subtract", "multiply",
        "divide", "minimum", "maximum", "clip", "abs", "sign", "sqrt",
        "exp", "log", "floor", "ceil", "round", "logical_and",
        "logical_or", "logical_not", "isnan", "isin", "equal",
        "not_equal", "less", "greater", "argmax", "argmin",
    }
)

_FLOAT_CONSTRUCTORS = frozenset({"tensor", "full", "arange", "linspace"})

# torch.* calls that return static host values (dtype, device and shape
# metadata, modes): not tensors
_TORCH_STATIC = frozenset(
    {
        "is_tensor", "is_floating_point", "is_complex",
        "device", "dtype", "finfo", "iinfo", "Size", "get_default_dtype",
        "promote_types", "result_type", "can_cast", "is_grad_enabled",
        "no_grad", "inference_mode", "enable_grad", "Generator",
        "get_num_threads", "set_num_threads", "manual_seed", "typename",
        "is_storage", "numel",
    }
)

# tensor methods that give static host values
_STATIC_METHODS = frozenset(
    {
        "numel", "dim", "size", "element_size", "nelement", "stride",
        "data_ptr", "is_contiguous", "storage_offset", "get_device",
        "is_floating_point", "is_complex", "untyped_storage", "ndimension",
    }
)
# methods numpy has not: a receiver that calls one is a tensor
_TENSOR_ONLY_METHODS = frozenset(
    {
        "cpu", "cuda", "to", "contiguous", "clone", "detach", "long",
        "int", "float", "double", "bool", "half", "short", "masked_fill",
        "masked_fill_", "index_select", "scatter_add", "scatter_add_",
        "index_put_", "index_add_", "index_copy_", "new_zeros", "new_full",
        "new_empty", "new_ones", "narrow", "expand", "unsqueeze", "amax",
        "amin", "logical_not", "bitwise_and", "bitwise_or", "copy_",
        "zero_", "fill_", "pin_memory", "record_stream",
    }
)
# attributes of a tensor that are tensors
_TENSOR_ATTRS = frozenset({"T", "mT", "real", "imag", "data", "grad"})

_TORCH, _NUMPY = "torch", "numpy"


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str  # repo-relative when under the repo, else as given
    rule: str
    func: str  # enclosing function qualname, or "<module>"
    lineno: int
    message: str

    @property
    def key(self) -> str:
        return f"{self.path}::{self.rule}::{self.func}"

    def render(self) -> str:
        return f"{self.path}:{self.lineno}: {self.rule} [{self.func}] {self.message}"


def _aliases(tree: ast.Module) -> tuple[set[str], set[str], set[str]]:
    """(torch aliases, np aliases, names bound to ``torch.Tensor``) of
    this module's imports."""
    torch_: set[str] = set()
    np: set[str] = set()
    tensor: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    torch_.add(a.asname or "torch")
                elif a.name == "numpy":
                    np.add(a.asname or "numpy")
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "Tensor":
                    tensor.add(a.asname or "Tensor")
    return torch_, np, tensor


def _dotted(node: ast.expr) -> Optional[list[str]]:
    """The names of a pure attribute chain (``torch.cuda.synchronize``),
    or None when a call or subscript is inside it."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return parts[::-1]


def _rooted_at(node: ast.expr, aliases: set[str]) -> bool:
    """True when a pure attribute chain bottoms out at one of `aliases`."""
    path = _dotted(node)
    return path is not None and path[0] in aliases


def _call_name(fn: ast.expr) -> Optional[str]:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _has_float_literal(node: ast.expr) -> bool:
    return any(
        isinstance(n, ast.Constant) and isinstance(n.value, float)
        for n in ast.walk(node)
    )


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, source_lines: list[str], torch_: set[str],
                 np: set[str], tensor: set[str]):
        self.path = path
        self.lines = source_lines
        self.torch = torch_
        self.np = np
        self.tensor_names = tensor
        self.stack: list[str] = []  # enclosing function names
        # name -> torch/numpy, one scope a function (a nested def starts
        # from a copy of its parent's: closures read the parent's names)
        self.envs: list[dict[str, str]] = [{}]
        self.allowed = 0  # depth of enclosing ``with allow_sync(...)``
        # per-function-scope JIT007 events: host pulls and fragment
        # dispatches, resolved when the scope closes (a pull only becomes
        # a violation if a dispatch follows it lexically)
        self.fn_pulls: list[list[tuple[int, ast.AST, str]]] = []
        self.fn_dispatches: list[list[int]] = []
        self.out: list[Violation] = []
        # every tensor read by method, allowed or not (the concurrency
        # lint's blocking host reads)
        self.reads: list[tuple[ast.Call, str]] = []

    # --- helpers ----------------------------------------------------------

    def _func(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def _suppressed(self, lineno: int, rule: str) -> bool:
        if 1 <= lineno <= len(self.lines):
            line = self.lines[lineno - 1]
            return f"lint: ignore[{rule}]" in line or "lint: ignore-all" in line
        return False

    def _flag(self, node: ast.AST, rule: str, detail: str = "") -> None:
        lineno = getattr(node, "lineno", 0)
        if self._suppressed(lineno, rule):
            return
        msg = RULES[rule] + (f" ({detail})" if detail else "")
        self.out.append(Violation(self.path, rule, self._func(), lineno, msg))

    def _is_tensor_annotation(self, ann: Optional[ast.expr]) -> bool:
        if ann is None:
            return False
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            text = ann.value
        else:
            try:
                text = ast.unparse(ann)
            except Exception:  # pragma: no cover - defensive
                return False
        text = text.replace(" ", "")
        if text.startswith("Optional[") and text.endswith("]"):
            text = text[len("Optional["):-1]
        parts = [p for p in text.split("|") if p != "None"]
        names = {f"{a}.Tensor" for a in self.torch} | self.tensor_names
        return len(parts) == 1 and parts[0] in names

    # --- the kind of an expression: torch, numpy or unknown ---------------

    def kind(self, node: Optional[ast.expr]) -> Optional[str]:  # noqa: C901
        if node is None:
            return None
        env = self.envs[-1]
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute):
                if _rooted_at(fn, self.torch):
                    # a function of the torch module: torch.cuda.* and the
                    # metadata functions give host values
                    if "cuda" in _dotted(fn)[1:] or fn.attr in _TORCH_STATIC:
                        return None
                    return _TORCH
                if _rooted_at(fn, self.np):
                    return _NUMPY
                recv = self.kind(fn.value)
                m = fn.attr
                if recv == _TORCH:
                    if m in ("item", "tolist") or m in _STATIC_METHODS:
                        return None
                    return _NUMPY if m == "numpy" else _TORCH
                if recv == _NUMPY:
                    return None if m in ("item", "tolist") else _NUMPY
                if m == "numpy":
                    return _NUMPY
                if m in _TENSOR_ONLY_METHODS:
                    return _TORCH
            return None
        if isinstance(node, ast.Attribute):
            if _rooted_at(node, self.torch):
                return None  # torch.float64, torch.cuda...
            inner = self.kind(node.value)
            if inner == _TORCH:
                return _TORCH if node.attr in _TENSOR_ATTRS else None
            if inner == _NUMPY:
                return None if node.attr in ("shape", "dtype", "ndim", "size") else _NUMPY
            return None
        if isinstance(node, ast.Subscript):
            return self.kind(node.value)
        if isinstance(node, ast.BinOp):
            kinds = {self.kind(node.left), self.kind(node.right)}
            return _TORCH if _TORCH in kinds else _NUMPY if _NUMPY in kinds else None
        if isinstance(node, ast.UnaryOp):
            return self.kind(node.operand)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return None
            kinds = {self.kind(x) for x in [node.left, *node.comparators]}
            return _TORCH if _TORCH in kinds else _NUMPY if _NUMPY in kinds else None
        if isinstance(node, ast.BoolOp):
            kinds = {self.kind(x) for x in node.values}
            return _TORCH if _TORCH in kinds else None
        if isinstance(node, ast.IfExp):
            kinds = {self.kind(node.body), self.kind(node.orelse)}
            return _TORCH if _TORCH in kinds else _NUMPY if _NUMPY in kinds else None
        if isinstance(node, ast.NamedExpr):
            return self.kind(node.value)
        return None

    def _bind(self, target: ast.expr, kind: Optional[str]) -> None:
        env = self.envs[-1]
        if isinstance(target, ast.Name):
            if kind is None:
                env.pop(target.id, None)
            else:
                env[target.id] = kind
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt.value if isinstance(elt, ast.Starred) else elt, kind)

    def _bind_value(self, target: ast.expr, value: ast.expr) -> None:
        if isinstance(target, (ast.Tuple, ast.List)) and isinstance(
            value, (ast.Tuple, ast.List)
        ) and len(target.elts) == len(value.elts):
            for t, v in zip(target.elts, value.elts):
                self._bind_value(t, v)
            return
        self._bind(target, self.kind(value))

    # --- scope tracking ---------------------------------------------------

    def _visit_fn(self, node) -> None:
        for d in node.decorator_list:
            self.visit(d)
        self.stack.append(node.name)
        env = dict(self.envs[-1])
        a = node.args
        for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs, a.vararg, a.kwarg]:
            if arg is None:
                continue
            if self._is_tensor_annotation(arg.annotation):
                env[arg.arg] = _TORCH
            else:
                env.pop(arg.arg, None)
        self.envs.append(env)
        self.fn_pulls.append([])
        self.fn_dispatches.append([])
        allowed, self.allowed = self.allowed, 0  # a nested def runs later
        for stmt in node.body:
            self.visit(stmt)
        self.allowed = allowed
        # JIT007 resolves at scope close: flag each pull that a fragment
        # dispatch follows (nested defs are their own scope, so the root
        # pull after run_units() in the dispatch loop stays clean)
        dispatches = self.fn_dispatches.pop()
        pulls = self.fn_pulls.pop()
        if node.name not in _JIT007_DEMUX_ALLOWED:
            for lineno, call, label in pulls:
                if any(d > lineno for d in dispatches):
                    self._flag(call, "JIT007", label)
        self.envs.pop()
        self.stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Lambda(self, node: ast.Lambda) -> None:
        env = dict(self.envs[-1])
        for arg in node.args.args:
            env.pop(arg.arg, None)
        self.envs.append(env)
        self.visit(node.body)
        self.envs.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.envs.append({})
        self.generic_visit(node)
        self.envs.pop()
        self.stack.pop()

    # --- bindings ---------------------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        for t in node.targets:
            if not isinstance(t, (ast.Name, ast.Tuple, ast.List)):
                self.visit(t)
            self._bind_value(t, node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
        if not isinstance(node.target, ast.Name):
            self.visit(node.target)
        if self._is_tensor_annotation(node.annotation):
            self._bind(node.target, _TORCH)
        elif node.value is not None:
            self._bind_value(node.target, node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        if self.kind(node.value) == _TORCH:
            self._bind(node.target, _TORCH)

    def visit_NamedExpr(self, node: ast.NamedExpr) -> None:
        self.visit(node.value)
        self._bind(node.target, self.kind(node.value))

    def _iter_kind(self, iter_expr: ast.expr) -> Optional[str]:
        k = self.kind(iter_expr)
        return k if k in (_TORCH, _NUMPY) else None

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node, node.iter)
        self.visit(node.iter)
        self._bind(node.target, self._iter_kind(node.iter))
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_With(self, node: ast.With) -> None:
        allow = any(
            isinstance(i.context_expr, ast.Call)
            and _call_name(i.context_expr.func) == "allow_sync"
            for i in node.items
        )
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self._bind(item.optional_vars, None)
        self.allowed += allow
        for stmt in node.body:
            self.visit(stmt)
        self.allowed -= allow

    # --- rules ------------------------------------------------------------

    def _read_method(self, node: ast.expr) -> Optional[str]:
        """``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` of a tensor."""
        if not isinstance(node, ast.Call) or node.args:
            return None
        fn = node.func
        if not isinstance(fn, ast.Attribute) or fn.attr not in _READ_METHODS:
            return None
        if fn.attr in ("cpu", "numpy") or self.kind(fn.value) == _TORCH:
            return f".{fn.attr}()"
        return None

    def _host_read(self, node: ast.Call) -> Optional[str]:
        """The name of the host read this call makes, if it makes one: a
        chain of reads (``x.cpu().numpy()``) is one read, its first."""
        fn = node.func
        if isinstance(fn, ast.Attribute):
            m = fn.attr
            read = self._read_method(node)
            if read is not None:
                if self._read_method(fn.value) is not None:
                    return None
                self.reads.append((node, read))
                return read
            if m in _DATA_DEPENDENT:
                if _rooted_at(fn, self.torch):
                    return f"torch.{m}"
                if self.kind(fn.value) == _TORCH:
                    return f".{m}()"
        return None

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        name = _call_name(fn)
        read = self._host_read(node)
        # JIT001: a host read outside allow_sync
        if read is not None and not self.allowed:
            self._flag(node, "JIT001", read)
        # JIT002: int()/float()/bool()/range() over a torch expression
        if (
            isinstance(fn, ast.Name)
            and fn.id in _CASTS
            and node.args
            and any(self.kind(a) == _TORCH for a in node.args)
            and not self.allowed
        ):
            self._flag(node, "JIT002", f"{fn.id}() on a torch value")
        # JIT004: torch.tensor(0.5, ...) without dtype=
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr in _FLOAT_CONSTRUCTORS
            and _rooted_at(fn, self.torch)
            and not any(k.arg == "dtype" for k in node.keywords)
            and any(_has_float_literal(a) for a in node.args)
        ):
            self._flag(node, "JIT004", f"torch.{fn.attr}")
        # JIT006: np compute over a torch expression
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr in _NP_COMPUTE
            and _rooted_at(fn, self.np)
            and any(self.kind(a) == _TORCH for a in node.args)
        ):
            self._flag(node, "JIT006", f"np.{fn.attr}")
        # JIT007: record host pulls and fragment dispatches per scope
        if self.fn_pulls:
            if name in ("to_host", "host_read") or (
                read is not None and read.strip(".()") in _READ_METHODS
            ):
                self.fn_pulls[-1].append((node.lineno, node, f"{name}()"))
            elif name in _FRAGMENT_DISPATCH:
                self.fn_dispatches[-1].append(node.lineno)
        self.generic_visit(node)

    def _check_branch(self, node) -> None:
        # JIT003: the branch condition is a torch expression (its truth
        # value is read from the card); metadata reads are static
        if self.kind(node.test) == _TORCH and not self.allowed:
            self._flag(node, "JIT003", "condition is a torch value")
        self.generic_visit(node)

    visit_If = _check_branch
    visit_While = _check_branch

    def _check_iter(self, node, iter_expr: ast.expr) -> None:
        # JIT005: for x in {…} / set(…) / frozenset(…) / set comprehension
        bad = isinstance(iter_expr, (ast.Set, ast.SetComp)) or (
            isinstance(iter_expr, ast.Call)
            and isinstance(iter_expr.func, ast.Name)
            and iter_expr.func.id in ("set", "frozenset")
        )
        if bad:
            self._flag(node, "JIT005")

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(node, gen.iter)
            self.visit(gen.iter)
            self._bind(gen.target, self._iter_kind(gen.iter))
            for cond in gen.ifs:
                self.visit(cond)
        for part in ("elt", "key", "value"):
            sub = getattr(node, part, None)
            if sub is not None:
                self.visit(sub)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp


@functools.lru_cache(maxsize=1024)
def _parsed(path: str, source: str) -> ast.Module:
    return ast.parse(source, filename=path)


def parse_file(path: Path) -> tuple[str, ast.Module]:
    """(source, tree) of ``path``, parsed once while its text is the same:
    the three families read the same files."""
    source = path.read_text()
    return source, _parsed(str(path), source)


@functools.lru_cache(maxsize=1024)
def _scanned(path: str, source: str) -> _Visitor:
    tree = _parsed(path, source)
    torch_, np, tensor = _aliases(tree)
    v = _Visitor(_rel(Path(path)), source.splitlines(), torch_, np, tensor)
    v.visit(tree)
    return v


def node_span(node: ast.AST) -> tuple[int, int, int, int]:
    """Where a node is in its source: a call and its receiver's call start
    at one place, and only their ends differ."""
    return (node.lineno, node.col_offset, node.end_lineno, node.end_col_offset)


def tensor_reads(path: Path) -> dict[tuple[int, int, int, int], str]:
    """:func:`node_span` -> label of every ``.item()``, ``.tolist()``,
    ``.cpu()`` and ``.numpy()`` of a torch expression in ``path``."""
    v = _scanned(str(path), path.read_text())
    return {node_span(n): label for n, label in v.reads}


def lint_file(path: Path) -> list[Violation]:
    try:
        v = _scanned(str(path), path.read_text())
    except (SyntaxError, UnicodeDecodeError, OSError) as e:
        return [
            Violation(_rel(path), "JIT000", "<module>", 0, f"unparseable: {e}")
        ]
    return list(v.out)


def _rel(path: Path) -> str:
    try:
        return path.resolve().relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return str(path)


def lint_paths(paths: Iterable[str | Path]) -> list[Violation]:
    out: list[Violation] = []
    for p in paths:
        p = Path(p)
        if not p.is_absolute() and not p.exists():
            p = REPO_ROOT / p
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            out.extend(lint_file(f))
    return sorted(out, key=lambda v: (v.path, v.lineno, v.rule))


# === suppression baseline ===================================================


def to_baseline(violations: Iterable[Violation]) -> dict:
    counts: dict[str, int] = {}
    for v in violations:
        counts[v.key] = counts.get(v.key, 0) + 1
    return {"version": 1, "entries": dict(sorted(counts.items()))}


def load_baseline(path: Path = BASELINE_PATH) -> dict:
    if not path.exists():
        return {"version": 1, "entries": {}}
    return json.loads(path.read_text())


def compare_to_baseline(
    violations: list[Violation], baseline: dict
) -> tuple[list[Violation], list[str]]:
    """(new violations beyond baseline, stale baseline keys)."""
    allowed: dict[str, int] = dict(baseline.get("entries", {}))
    seen: dict[str, int] = {}
    new: list[Violation] = []
    for v in violations:
        seen[v.key] = seen.get(v.key, 0) + 1
        if seen[v.key] > allowed.get(v.key, 0):
            new.append(v)
    stale = [k for k, n in allowed.items() if seen.get(k, 0) < n]
    return new, stale


# === CLI ====================================================================


def main(argv: Optional[list[str]] = None) -> int:
    from trino_tpu_torch.lint.cli import main as cli_main

    return cli_main(["--only", "jit"] + list(argv or []))


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main(sys.argv[1:]))
