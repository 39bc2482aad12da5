"""The string and date half of trino_tpu_torch's expression tier against
the JAX reference, on the CPU.

Expression level: the same dictionary-coded VARCHAR columns (NULLs
included) and DATE columns go into the port's and the reference's
``ExprCompiler``; comparisons against literals and across two
dictionaries, VARCHAR ``IN``, ``LIKE``, ``length``/``strpos``/
``starts_with``, string->string functions lowered by
``lower_string_calls``, and the date functions must give the same values
where valid and the same validity. SQL level: the same memory table in
both engines, queries through ``LIKE ... ESCAPE``, string-valued
projections and ``extract``/``date_trunc``; rows must be equal. Exact
throughout: the tolerance is zero.
"""

import numpy as np
import pytest
import torch

from trino_tpu import types as RT
from trino_tpu.columnar import Batch as RBatch, Column as RColumn, Dictionary as RDict
from trino_tpu.compiler import ExprCompiler as RCompiler
from trino_tpu.connectors.api import ColumnSchema as RCS, TableSchema as RTS
from trino_tpu.strings import lower_string_calls as r_lower
from trino_tpu.testing import LocalQueryRunner as RefRunner
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, Dictionary
from trino_tpu_torch.compiler import ExprCompiler
from trino_tpu_torch.connectors.api import ColumnSchema, TableSchema
from trino_tpu_torch.ir import Call, Constant, InputRef, SpecialForm
from trino_tpu_torch.strings import lower_string_calls
from trino_tpu_torch.testing import LocalQueryRunner

N = 400
WORDS_A = ["apple", "banana", "", "Apricot", "a_c", "abc", "a%c", "cherry pie",
           "  trim me  ", "Ünïcode", "zeta"]
WORDS_B = ["banana", "apple", "date", "abc", "zz", "", "Apricot"]


def _codes(rng, values, null_share):
    codes = rng.integers(0, len(values), N).astype(np.int32)
    valid = rng.random(N) >= null_share
    return np.where(valid, codes, -1).astype(np.int32), valid


@pytest.fixture(scope="module")
def columns():
    """(port columns, reference columns): 0 and 1 VARCHAR over two
    dictionaries with NULLs, 2 a VARCHAR sharing column 0's dictionary, 3
    a DATE with NULLs."""
    rng = np.random.default_rng(11)
    a, av = _codes(rng, WORDS_A, 0.1)
    b, bv = _codes(rng, WORDS_B, 0.2)
    c, cv = _codes(rng, WORDS_A, 0.0)
    days = rng.integers(-800, 20000, N).astype(np.int32)
    dv = rng.random(N) >= 0.1
    da, db = Dictionary(WORDS_A), Dictionary(WORDS_B)
    rda, rdb = RDict(WORDS_A), RDict(WORDS_B)
    port = [
        Column(T.VARCHAR, torch.from_numpy(a), torch.from_numpy(av), da),
        Column(T.VARCHAR, torch.from_numpy(b), torch.from_numpy(bv), db),
        Column(T.VARCHAR, torch.from_numpy(c), None, da),
        Column(T.DATE, torch.from_numpy(days), torch.from_numpy(dv)),
    ]
    ref = [
        RColumn(RT.VARCHAR, a, av, rda),
        RColumn(RT.VARCHAR, b, bv, rdb),
        RColumn(RT.VARCHAR, c, None, rda),
        RColumn(RT.DATE, days, dv),
    ]
    return port, ref


def _ref_ir(e):
    """The same IR tree in the reference's classes."""
    from trino_tpu import ir as RIR

    if isinstance(e, InputRef):
        return RIR.InputRef(type=_ref_type(e.type), channel=e.channel)
    if isinstance(e, Constant):
        return RIR.Constant(type=_ref_type(e.type), value=e.value)
    args = tuple(_ref_ir(a) for a in e.args)
    if isinstance(e, SpecialForm):
        return RIR.SpecialForm(type=_ref_type(e.type), form=e.form, args=args)
    return RIR.Call(type=_ref_type(e.type), name=e.name, args=args)


def _ref_type(t):
    return RT.parse_type(t.name)


def _eval_both(columns, expr):
    port_cols, ref_cols = list(columns[0]), list(columns[1])
    pe = lower_string_calls(expr, port_cols)
    re_ = r_lower(_ref_ir(expr), ref_cols)
    got_d, got_v = ExprCompiler(port_cols, device="cpu").evaluate(pe)
    want_d, want_v = RCompiler(ref_cols).evaluate(re_)
    want_d, want_v = np.asarray(want_d), np.asarray(want_v)
    got_d, got_v = got_d.numpy(), got_v.numpy()
    np.testing.assert_array_equal(got_v, want_v)
    if T.is_string(expr.type):
        # string results: the decoded values, row by row
        pd = port_cols[pe.channel].dictionary if isinstance(pe, InputRef) else None
        rd = ref_cols[re_.channel].dictionary if hasattr(re_, "channel") else None
        got = [pd.decode(int(x)) if v else None for x, v in zip(got_d, got_v)]
        want = [rd.decode(int(x)) if v else None for x, v in zip(want_d, want_v)]
        assert got == want
    else:
        np.testing.assert_array_equal(got_d[got_v], want_d[want_v])


def col(i, t=T.VARCHAR):
    return InputRef(type=t, channel=i)


def lit(v, t=T.VARCHAR):
    return Constant(type=t, value=v)


def call(name, t, *args):
    return Call(type=t, name=name, args=tuple(args))


CMP = ["eq", "ne", "lt", "le", "gt", "ge"]


@pytest.mark.parametrize("op", CMP)
@pytest.mark.parametrize("literal", ["banana", "b", "", "zzz", "Apricot"])
def test_compare_with_literal(columns, op, literal):
    _eval_both(columns, call(op, T.BOOLEAN, col(0), lit(literal)))
    _eval_both(columns, call(op, T.BOOLEAN, lit(literal), col(0)))  # flipped


@pytest.mark.parametrize("op", CMP)
@pytest.mark.parametrize("other", [1, 2])  # another dictionary, the same one
def test_compare_two_columns(columns, op, other):
    _eval_both(columns, call(op, T.BOOLEAN, col(0), col(other)))


def test_varchar_in(columns):
    _eval_both(columns, SpecialForm(
        type=T.BOOLEAN, form="in",
        args=(col(0), lit("apple"), lit("zeta"), lit("absent")),
    ))
    _eval_both(columns, SpecialForm(
        type=T.BOOLEAN, form="in", args=(col(1), lit("zz"), lit(None)),
    ))


@pytest.mark.parametrize(
    "pattern", ["%a%", "a_c", "abc", "%", "", "A%", "%pie", "a%c", "_", "%ü%"]
)
def test_like(columns, pattern):
    _eval_both(columns, call("like", T.BOOLEAN, col(0), lit(pattern)))
    _eval_both(columns, SpecialForm(
        type=T.BOOLEAN, form="not",
        args=(call("like", T.BOOLEAN, col(1), lit(pattern)),),
    ))


@pytest.mark.parametrize("expr", [
    call("length", T.BIGINT, col(0)),
    call("strpos", T.BIGINT, col(0), lit("an")),
    call("starts_with", T.BOOLEAN, col(1), lit("a")),
    call("codepoint", T.BIGINT, col(1)),
], ids=["length", "strpos", "starts_with", "codepoint"])
def test_string_to_number(columns, expr):
    _eval_both(columns, expr)


@pytest.mark.parametrize("expr", [
    call("substr", T.VARCHAR, col(0), lit(2, T.BIGINT), lit(3, T.BIGINT)),
    call("substr", T.VARCHAR, col(0), lit(-3, T.BIGINT)),
    call("upper", T.VARCHAR, col(0)),
    call("lower", T.VARCHAR, col(1)),
    call("trim", T.VARCHAR, col(0)),
    call("concat", T.VARCHAR, col(0), lit("-"), col(1)),
    call("length", T.BIGINT, call("upper", T.VARCHAR, call("trim", T.VARCHAR, col(0)))),
    call("eq", T.BOOLEAN, call("substr", T.VARCHAR, col(0), lit(1, T.BIGINT),
                               lit(1, T.BIGINT)), lit("a")),
], ids=["substr", "substr-negative", "upper", "lower", "trim", "concat",
        "length-upper-trim", "substr-eq"])
def test_lowered_string_functions(columns, expr):
    _eval_both(columns, expr)


@pytest.mark.parametrize("name", [
    "year", "month", "day", "day_of_week", "day_of_year", "week", "quarter",
    "last_day_of_month",
])
def test_date_fields(columns, name):
    t = T.DATE if name == "last_day_of_month" else T.BIGINT
    _eval_both(columns, call(name, t, col(3, T.DATE)))


@pytest.mark.parametrize("unit", ["year", "quarter", "month", "week", "day"])
def test_date_trunc(columns, unit):
    _eval_both(columns, call("date_trunc", T.DATE, lit(unit), col(3, T.DATE)))


# --- SQL level ------------------------------------------------------------

ROWS = [  # (s, t, d): VARCHAR, VARCHAR, DATE
    ("a_b", "x", "1994-01-31"), ("a%b", "y", "1995-02-28"),
    ("axb", None, "1996-02-29"), (None, "x", "1998-12-31"),
    ("PROMO BRUSHED", "y", None), ("forest green", "z", "1992-07-04"),
    ("13-555-0101", "x", "1993-10-01"), ("  pad ", "y", "2000-03-01"),
    ("a!_z", "x", "1997-05-05"),
]


def _port_column(t, rc):
    """The reference column's data, validity and dictionary as a port
    column."""
    data, valid = rc.to_numpy()
    d = None if rc.dictionary is None else Dictionary(list(rc.dictionary.values))
    return Column(t, torch.from_numpy(data.copy()), torch.from_numpy(valid.copy()), d)


@pytest.fixture(scope="module")
def runners():
    ref, port = RefRunner(), LocalQueryRunner(device="cpu")
    s = [r[0] for r in ROWS]
    t = [r[1] for r in ROWS]
    d = [r[2] for r in ROWS]
    ref_mem, port_mem = ref.catalogs.get("memory"), port.catalogs.get("memory")
    ref_mem.create_table("default", "str", RTS("str", (
        RCS("s", RT.VARCHAR), RCS("t", RT.VARCHAR), RCS("d", RT.DATE))))
    ref_cols = [RColumn.from_values(RT.VARCHAR, s),
                RColumn.from_values(RT.VARCHAR, t), RColumn.from_values(RT.DATE, d)]
    ref_mem.insert("default", "str", RBatch(ref_cols, len(ROWS)))
    port_mem.create_table("default", "str", TableSchema("str", (
        ColumnSchema("s", T.VARCHAR), ColumnSchema("t", T.VARCHAR),
        ColumnSchema("d", T.DATE))))
    port_mem.insert("default", "str", Batch([
        _port_column(t, c) for t, c in zip((T.VARCHAR, T.VARCHAR, T.DATE), ref_cols)
    ], len(ROWS)))
    return ref, port


SQL = {
    # both analyzers drop the ESCAPE clause: '!' is a plain character
    "like-escape": "select s from memory.default.str where s like 'a!_%' escape '!'",
    "like-null": "select s, s like '%b' from memory.default.str",
    "substr-in": ("select s from memory.default.str "
                  "where substr(s, 1, 2) in ('13', '31', 'fo')"),
    "upper-lower-trim-concat": ("select upper(s), lower(t), trim(s), "
                                "concat(s, '/', t) from memory.default.str"),
    "length-strpos": "select length(s), strpos(s, 'b') from memory.default.str",
    "case-projection": ("select case when s like 'a%' then t else 'other' end, "
                        "coalesce(t, 'none') from memory.default.str"),
    "compare-columns": "select s, t from memory.default.str where s < t",
    "extract": ("select extract(year from d), year(d), month(d), day(d), "
                "extract(quarter from d) from memory.default.str"),
    "date-trunc": ("select date_trunc('month', d), date_trunc('year', d), "
                   "date_trunc('quarter', d) from memory.default.str"),
    "group-by-substr": ("select substr(t, 1, 1), count(*) from memory.default.str "
                        "group by 1"),
}


@pytest.mark.parametrize("mode", ["local", "distributed"])
@pytest.mark.parametrize("name", sorted(SQL))
def test_string_and_date_sql_matches_reference(runners, name, mode):
    ref, port = runners
    want = ref.execute(SQL[name])[0]
    port.session.set("execution_mode", mode)
    got = port.execute(SQL[name])[0]
    assert sorted(got, key=repr) == sorted(want, key=repr) and len(want) > 0
