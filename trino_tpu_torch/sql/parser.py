"""Recursive-descent + Pratt SQL parser.

Reference: ``core/trino-parser/src/main/java/io/trino/sql/parser/SqlParser.java:44,82``
and the grammar ``SqlBase.g4`` (precedence: OR < AND < NOT < predicate
(comparison/BETWEEN/IN/LIKE/IS) < additive/|| < multiplicative < unary).
"""

from __future__ import annotations

from typing import Optional

from trino_tpu_torch.sql import tree as t
from trino_tpu_torch.sql.lexer import SqlSyntaxError, Token, tokenize


def parse_statement(sql: str) -> t.Node:
    return Parser(tokenize(sql)).parse_statement()


def parse_expression(sql: str) -> t.Node:
    p = Parser(tokenize(sql))
    e = p.expression()
    p.expect_eof()
    return e


class Parser:
    def __init__(self, tokens: list[Token]):
        self.tokens = tokens
        self.pos = 0
        self._param_index = 0

    # --- token helpers ---------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.pos + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        tok = self.tokens[self.pos]
        if tok.kind != "EOF":
            self.pos += 1
        return tok

    def at_kw(self, *kws: str) -> bool:
        tok = self.peek()
        return tok.kind == "KW" and tok.upper in kws

    def at_op(self, *ops: str) -> bool:
        tok = self.peek()
        return tok.kind == "OP" and tok.text in ops

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> Token:
        tok = self.peek()
        if not self.at_kw(kw):
            raise SqlSyntaxError(f"expected {kw}, found {tok.text!r}", tok.line, tok.col)
        return self.next()

    def expect_op(self, op: str) -> Token:
        tok = self.peek()
        if not self.at_op(op):
            raise SqlSyntaxError(f"expected {op!r}, found {tok.text!r}", tok.line, tok.col)
        return self.next()

    def expect_eof(self):
        tok = self.peek()
        if tok.kind != "EOF":
            raise SqlSyntaxError(f"unexpected trailing input {tok.text!r}", tok.line, tok.col)

    def identifier(self) -> str:
        tok = self.peek()
        if tok.kind in ("IDENT", "QIDENT"):
            self.next()
            return tok.text
        # non-reserved keywords usable as identifiers
        if tok.kind == "KW" and tok.upper in _NONRESERVED:
            self.next()
            return tok.text
        raise SqlSyntaxError(f"expected identifier, found {tok.text!r}", tok.line, tok.col)

    def qualified_name(self) -> tuple[str, ...]:
        parts = [self.identifier()]
        while self.accept_op("."):
            parts.append(self.identifier())
        return tuple(parts)

    # --- statements ------------------------------------------------------
    def parse_statement(self) -> t.Node:
        stmt = self._statement()
        self.accept_op(";")
        self.expect_eof()
        return stmt

    def _statement(self) -> t.Node:
        if self.at_kw("EXPLAIN"):
            self.next()
            analyze = self.accept_kw("ANALYZE")
            return t.Explain(self._statement(), analyze=analyze)
        if self.at_kw("SET"):
            self.next()
            self.expect_kw("SESSION")
            name = ".".join(self.qualified_name())
            self.expect_op("=")
            value = self.expression()
            return t.SetSession(name, value)
        if self.at_kw("SHOW"):
            self.next()
            if self.accept_kw("TABLES"):
                schema = None
                if self.accept_kw("FROM") or self.accept_kw("IN"):
                    schema = self.qualified_name()
                return t.ShowTables(schema)
            if self.accept_kw("SCHEMAS"):
                catalog = None
                if self.accept_kw("FROM") or self.accept_kw("IN"):
                    catalog = self.identifier()
                return t.ShowSchemas(catalog)
            if self.accept_kw("CATALOGS"):
                return t.ShowCatalogs()
            if self.accept_kw("COLUMNS"):
                self.expect_kw("FROM")
                return t.ShowColumns(self.qualified_name())
            tok = self.peek()
            raise SqlSyntaxError(f"unsupported SHOW {tok.text!r}", tok.line, tok.col)
        if self.at_kw("DESCRIBE"):
            self.next()
            return t.ShowColumns(self.qualified_name())
        if self.at_kw("CREATE"):
            self.next()
            self.expect_kw("TABLE")
            not_exists = False
            if self.at_kw("IF"):
                self.next()
                tok = self.peek()
                if tok.kind == "KW" and tok.upper == "NOT":
                    self.next()
                    self.expect_kw("EXISTS")
                    not_exists = True
            name = self.qualified_name()
            if self.at_op("("):
                self.expect_op("(")
                cols = []
                while True:
                    cname = self.identifier()
                    ty = self._type_text()
                    cols.append((cname, ty))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                return t.CreateTable(name, tuple(cols), not_exists)
            self.expect_kw("AS")
            return t.CreateTableAsSelect(name, self.query())
        if self.at_kw("DELETE"):
            self.next()
            self.expect_kw("FROM")
            name = self.qualified_name()
            where = self.expression() if self.accept_kw("WHERE") else None
            return t.Delete(name, where)
        if self.at_kw("PREPARE"):
            self.next()
            name = self.identifier()
            self.expect_kw("FROM")
            stmt = self._statement()
            return t.Prepare(name, stmt)
        if self.at_kw("EXECUTE"):
            self.next()
            name = self.identifier()
            params: tuple[t.Node, ...] = ()
            if self.accept_kw("USING"):
                ps = [self.expression()]
                while self.accept_op(","):
                    ps.append(self.expression())
                params = tuple(ps)
            return t.Execute(name, params)
        if self.at_kw("START"):
            self.next()
            self.expect_kw("TRANSACTION")
            return t.StartTransaction()
        if self.at_kw("COMMIT"):
            self.next()
            return t.Commit()
        if self.at_kw("ROLLBACK"):
            self.next()
            return t.Rollback()
        if self.at_kw("DEALLOCATE"):
            self.next()
            self.expect_kw("PREPARE")
            return t.Deallocate(self.identifier())
        if self.at_kw("INSERT"):
            self.next()
            self.expect_kw("INTO")
            name = self.qualified_name()
            columns: tuple[str, ...] = ()
            if self.at_op("(") and self._looks_like_column_list():
                self.expect_op("(")
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                columns = tuple(cols)
            return t.InsertInto(name, columns, self.query())
        if self.at_kw("DROP"):
            self.next()
            self.expect_kw("TABLE")
            if_exists = False
            if self.at_kw("IF"):
                self.next()
                # IF EXISTS
                tok = self.peek()
                if tok.kind == "KW" and tok.upper == "EXISTS":
                    self.next()
                    if_exists = True
            return t.DropTable(self.qualified_name(), if_exists)
        return self.query()

    def _looks_like_column_list(self) -> bool:
        # distinguish INSERT INTO t (a, b) SELECT ... from INSERT INTO t (SELECT ...)
        i = 1
        tok = self.peek(i)
        return tok.kind in ("IDENT", "QIDENT") or (
            tok.kind == "KW" and tok.upper in _NONRESERVED
        )

    # --- query -----------------------------------------------------------
    def query(self) -> t.Query:
        with_queries: list[t.WithQuery] = []
        if self.accept_kw("WITH"):
            self.accept_kw("RECURSIVE")  # parsed, not supported in analyzer
            while True:
                name = self.identifier()
                column_aliases: tuple[str, ...] = ()
                if self.at_op("("):
                    self.expect_op("(")
                    cols = [self.identifier()]
                    while self.accept_op(","):
                        cols.append(self.identifier())
                    self.expect_op(")")
                    column_aliases = tuple(cols)
                self.expect_kw("AS")
                self.expect_op("(")
                q = self.query()
                self.expect_op(")")
                with_queries.append(t.WithQuery(name, q, column_aliases))
                if not self.accept_op(","):
                    break
        body = self._set_operation()
        order_by: tuple[t.SortItem, ...] = ()
        if self.at_kw("ORDER"):
            order_by = self._order_by()
        limit: Optional[int] = None
        offset = 0
        if self.accept_kw("OFFSET"):
            offset = int(self.next().text)
            self.accept_kw("ROWS") or self.accept_kw("ROW")
        if self.accept_kw("LIMIT"):
            tok = self.next()
            limit = None if tok.upper == "ALL" else int(tok.text)
            if self.accept_kw("OFFSET"):  # LIMIT n OFFSET m order
                offset = int(self.next().text)
                self.accept_kw("ROWS") or self.accept_kw("ROW")
        elif self.accept_kw("FETCH"):
            self.accept_kw("FIRST") or self.accept_kw("NEXT")
            limit = int(self.next().text)
            self.accept_kw("ROWS") or self.accept_kw("ROW")
            self.expect_kw("ONLY")
        return t.Query(body, tuple(with_queries), order_by, limit, offset)

    def _order_by(self) -> tuple[t.SortItem, ...]:
        self.expect_kw("ORDER")
        self.expect_kw("BY")
        items = [self._sort_item()]
        while self.accept_op(","):
            items.append(self._sort_item())
        return tuple(items)

    def _sort_item(self) -> t.SortItem:
        e = self.expression()
        ascending = True
        if self.accept_kw("ASC"):
            pass
        elif self.accept_kw("DESC"):
            ascending = False
        nulls_first: Optional[bool] = None
        if self.accept_kw("NULLS"):
            if self.accept_kw("FIRST"):
                nulls_first = True
            else:
                self.expect_kw("LAST")
                nulls_first = False
        return t.SortItem(e, ascending, nulls_first)

    def _set_operation(self) -> t.Node:
        # SQL precedence: INTERSECT binds tighter than UNION/EXCEPT
        left = self._intersect_term()
        while self.at_kw("UNION", "EXCEPT"):
            op = self.next().upper
            distinct = True
            if self.accept_kw("ALL"):
                distinct = False
            else:
                self.accept_kw("DISTINCT")
            right = self._intersect_term()
            left = t.SetOperation(op, distinct, left, right)
        return left

    def _intersect_term(self) -> t.Node:
        left = self._query_term()
        while self.at_kw("INTERSECT"):
            self.next()
            distinct = True
            if self.accept_kw("ALL"):
                distinct = False
            else:
                self.accept_kw("DISTINCT")
            right = self._query_term()
            left = t.SetOperation("INTERSECT", distinct, left, right)
        return left

    def _query_term(self) -> t.Node:
        if self.at_op("("):
            # parenthesized query
            self.expect_op("(")
            q = self.query()
            self.expect_op(")")
            return q.body if not (q.order_by or q.limit or q.with_queries) else q
        if self.at_kw("VALUES"):
            self.next()
            rows = [self._values_row()]
            while self.accept_op(","):
                rows.append(self._values_row())
            return t.Values(tuple(rows))
        return self._query_spec()

    def _values_row(self) -> tuple[t.Node, ...]:
        if self.accept_op("("):
            items = [self.expression()]
            while self.accept_op(","):
                items.append(self.expression())
            self.expect_op(")")
            return tuple(items)
        return (self.expression(),)

    def _query_spec(self) -> t.QuerySpec:
        self.expect_kw("SELECT")
        distinct = False
        if self.accept_kw("DISTINCT"):
            distinct = True
        else:
            self.accept_kw("ALL")
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        from_: Optional[t.Node] = None
        if self.accept_kw("FROM"):
            from_ = self._relation()
            while self.accept_op(","):
                right = self._relation()
                from_ = t.Join("CROSS", from_, right)
        where = self.expression() if self.accept_kw("WHERE") else None
        group_by: tuple[t.Node, ...] = ()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            exprs = [self._group_by_element()]
            while self.accept_op(","):
                exprs.append(self._group_by_element())
            group_by = tuple(exprs)
        having = self.expression() if self.accept_kw("HAVING") else None
        return t.QuerySpec(tuple(items), distinct, from_, where, group_by, having)

    def _group_by_element(self) -> t.Node:
        """Plain expression, or ROLLUP/CUBE/GROUPING SETS
        (reference grammar: SqlBase.g4 groupingElement)."""
        if self.at_kw("ROLLUP") or self.at_kw("CUBE"):
            kind = self.next().upper
            self.expect_op("(")
            cols = [self.expression()]
            while self.accept_op(","):
                cols.append(self.expression())
            self.expect_op(")")
            cols = tuple(cols)
            if kind == "ROLLUP":
                sets = tuple(tuple(cols[:i]) for i in range(len(cols), -1, -1))
            else:  # CUBE: all subsets, larger first
                import itertools as _it

                sets = tuple(
                    tuple(c)
                    for r in range(len(cols), -1, -1)
                    for c in _it.combinations(cols, r)
                )
            return t.GroupingSets(kind, sets)
        if self.at_kw("GROUPING"):
            save = self.pos
            self.next()
            if self.accept_kw("SETS"):
                self.expect_op("(")
                sets = []
                while True:
                    if self.accept_op("("):
                        inner = []
                        if not self.at_op(")"):
                            inner.append(self.expression())
                            while self.accept_op(","):
                                inner.append(self.expression())
                        self.expect_op(")")
                        sets.append(tuple(inner))
                    else:
                        sets.append((self.expression(),))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                return t.GroupingSets("GROUPING SETS", tuple(sets))
            self.pos = save  # grouping(...) function call
        return self.expression()

    def _select_item(self) -> t.SelectItem:
        if self.at_op("*"):
            self.next()
            return t.SelectItem(t.Star())
        # qualified star: only single-qualifier `t.*` is supported
        if (
            self.peek().kind in ("IDENT", "QIDENT")
            and self.peek(1).kind == "OP"
            and self.peek(1).text == "."
            and self.peek(2).kind == "OP"
            and self.peek(2).text == "*"
        ):
            q = self.identifier()
            self.expect_op(".")
            self.expect_op("*")
            return t.SelectItem(t.Star(qualifier=q))
        e = self.expression()
        alias = None
        if self.accept_kw("AS"):
            alias = self.identifier()
        elif self.peek().kind in ("IDENT", "QIDENT") or (
            self.peek().kind == "KW" and self.peek().upper in _NONRESERVED
        ):
            alias = self.identifier()
        return t.SelectItem(e, alias)

    # --- relations -------------------------------------------------------
    def _relation(self) -> t.Node:
        left = self._aliased_relation()
        while True:
            if self.accept_kw("CROSS"):
                self.expect_kw("JOIN")
                right = self._aliased_relation()
                left = t.Join("CROSS", left, right)
                continue
            join_type = None
            if self.at_kw("JOIN"):
                join_type = "INNER"
                self.next()
            elif self.at_kw("INNER"):
                self.next()
                self.expect_kw("JOIN")
                join_type = "INNER"
            elif self.at_kw("LEFT", "RIGHT", "FULL"):
                join_type = self.next().upper
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
            if join_type is None:
                return left
            right = self._aliased_relation()
            if self.accept_kw("ON"):
                criteria = self.expression()
                left = t.Join(join_type, left, right, criteria=criteria)
            elif self.accept_kw("USING"):
                self.expect_op("(")
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                left = t.Join(join_type, left, right, using=tuple(cols))
            else:
                tok = self.peek()
                raise SqlSyntaxError("JOIN requires ON or USING", tok.line, tok.col)

    def _aliased_relation(self) -> t.Node:
        rel = self._primary_relation()
        alias = None
        column_aliases: tuple[str, ...] = ()
        if self.accept_kw("AS"):
            alias = self.identifier()
        elif self.peek().kind in ("IDENT", "QIDENT") or (
            self.peek().kind == "KW" and self.peek().upper in _NONRESERVED
        ):
            alias = self.identifier()
        if alias is not None and self.at_op("(") and self._is_alias_list():
            self.expect_op("(")
            cols = [self.identifier()]
            while self.accept_op(","):
                cols.append(self.identifier())
            self.expect_op(")")
            column_aliases = tuple(cols)
        if alias is not None:
            return t.AliasedRelation(rel, alias, column_aliases)
        return rel

    def _is_alias_list(self) -> bool:
        tok = self.peek(1)
        return tok.kind in ("IDENT", "QIDENT") and self.peek(2).kind == "OP" and self.peek(2).text in (",", ")")

    def _primary_relation(self) -> t.Node:
        tok = self.peek()
        if (
            tok.kind == "IDENT"
            and tok.upper == "UNNEST"
            and self.peek(1).kind == "OP"
            and self.peek(1).text == "("
        ):
            self.next()
            self.expect_op("(")
            exprs = [self.expression()]
            while self.accept_op(","):
                exprs.append(self.expression())
            self.expect_op(")")
            with_ord = False
            if self.at_kw("WITH"):
                self.next()
                ident = self.next()
                if ident.upper != "ORDINALITY":
                    raise SqlSyntaxError(
                        "expected ORDINALITY", ident.line, ident.col
                    )
                with_ord = True
            return t.Unnest(tuple(exprs), with_ord)
        if self.at_op("("):
            self.expect_op("(")
            if self.at_kw("SELECT", "WITH", "VALUES"):
                q = self.query()
                self.expect_op(")")
                return t.SubqueryRelation(q)
            if self.at_op("("):
                # ambiguous: "((select ...) except (select ...))" is a
                # set-op subquery; "((a join b) ...)" is a relation.
                # Try the query grammar first, backtrack on failure.
                save = self.pos
                try:
                    q = self.query()
                    self.expect_op(")")
                    return t.SubqueryRelation(q)
                except SqlSyntaxError:
                    self.pos = save
            rel = self._relation()
            self.expect_op(")")
            return rel
        if self.at_kw("VALUES"):
            self.next()
            rows = [self._values_row()]
            while self.accept_op(","):
                rows.append(self._values_row())
            return t.SubqueryRelation(t.Query(t.Values(tuple(rows))))
        return t.Table(self.qualified_name())

    # --- expressions (Pratt) --------------------------------------------
    def expression(self) -> t.Node:
        return self._or_expr()

    def _or_expr(self) -> t.Node:
        left = self._and_expr()
        while self.accept_kw("OR"):
            left = t.BinaryOp("OR", left, self._and_expr())
        return left

    def _and_expr(self) -> t.Node:
        left = self._not_expr()
        while self.accept_kw("AND"):
            left = t.BinaryOp("AND", left, self._not_expr())
        return left

    def _not_expr(self) -> t.Node:
        if self.accept_kw("NOT"):
            return t.UnaryOp("NOT", self._not_expr())
        return self._predicate()

    def _predicate(self) -> t.Node:
        left = self._additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().text
                if op == "!=":
                    op = "<>"
                if self.at_kw("ANY", "SOME", "ALL"):
                    quant = self.next().upper
                    if quant == "SOME":
                        quant = "ANY"
                    self.expect_op("(")
                    q = self.query()
                    self.expect_op(")")
                    left = t.QuantifiedComparison(op, quant, left, q)
                    continue
                right = self._additive()
                left = t.BinaryOp(op, left, right)
                continue
            negated = False
            save = self.pos
            if self.accept_kw("NOT"):
                negated = True
            if self.accept_kw("BETWEEN"):
                low = self._additive()
                self.expect_kw("AND")
                high = self._additive()
                left = t.Between(left, low, high, negated)
                continue
            if self.accept_kw("IN"):
                self.expect_op("(")
                if self.at_kw("SELECT", "WITH"):
                    q = self.query()
                    self.expect_op(")")
                    left = t.InSubquery(left, q, negated)
                else:
                    items = [self.expression()]
                    while self.accept_op(","):
                        items.append(self.expression())
                    self.expect_op(")")
                    left = t.InList(left, tuple(items), negated)
                continue
            if self.accept_kw("LIKE"):
                pattern = self._additive()
                escape = None
                if self.accept_kw("ESCAPE"):
                    escape = self._additive()
                left = t.Like(left, pattern, escape, negated)
                continue
            if negated:
                self.pos = save
                break
            if self.accept_kw("IS"):
                neg = self.accept_kw("NOT")
                self.expect_kw("NULL")
                left = t.IsNull(left, negated=neg)
                continue
            break
        return left

    def _additive(self) -> t.Node:
        left = self._multiplicative()
        while self.at_op("+", "-", "||"):
            op = self.next().text
            left = t.BinaryOp(op, left, self._multiplicative())
        return left

    def _multiplicative(self) -> t.Node:
        left = self._unary()
        while self.at_op("*", "/", "%"):
            op = self.next().text
            left = t.BinaryOp(op, left, self._unary())
        return left

    def _unary(self) -> t.Node:
        if self.at_op("-", "+"):
            op = self.next().text
            return t.UnaryOp(op, self._unary())
        out = self._primary()
        # postfix subscript: base[index] (ARRAY element / MAP value / ROW
        # field — reference SqlBase.g4 subscript rule)
        while self.at_op("["):
            self.next()
            idx = self.expression()
            self.expect_op("]")
            out = t.Subscript(out, idx)
        return out

    def _primary(self) -> t.Node:
        tok = self.peek()
        if tok.kind == "NUMBER":
            self.next()
            text = tok.text
            if "e" in text.lower():
                return t.Literal(float(text), "double")
            if "." in text:
                return t.Literal(text, "decimal")
            return t.Literal(int(text), "integer")
        if tok.kind == "STRING":
            self.next()
            return t.Literal(tok.text, "string")
        if tok.kind == "OP" and tok.text == "?":
            self.next()
            self._param_index += 1
            return t.Parameter(self._param_index - 1)
        if tok.kind == "OP" and tok.text == "(":
            self.next()
            if self.at_kw("SELECT", "WITH"):
                q = self.query()
                self.expect_op(")")
                return t.ScalarSubquery(q)
            e = self.expression()
            self.expect_op(")")
            return e
        if tok.kind == "KW":
            kw = tok.upper
            if kw == "NULL":
                self.next()
                return t.Literal(None, "null")
            if kw in ("TRUE", "FALSE"):
                self.next()
                return t.Literal(kw == "TRUE", "boolean")
            if kw == "DATE":
                # DATE 'yyyy-mm-dd'
                if self.peek(1).kind == "STRING":
                    self.next()
                    s = self.next().text
                    return t.Literal(s, "date")
            if kw == "TIMESTAMP":
                if self.peek(1).kind == "STRING":
                    self.next()
                    s = self.next().text
                    return t.Literal(s, "timestamp")
            if kw == "INTERVAL":
                self.next()
                sign = 1
                if self.accept_op("-"):
                    sign = -1
                elif self.accept_op("+"):
                    pass
                v = self.next()
                unit = self.next().upper.rstrip("S")
                return t.IntervalLiteral(int(v.text), unit.lower(), sign)
            if kw in ("CAST", "TRY_CAST"):
                self.next()
                self.expect_op("(")
                e = self.expression()
                self.expect_kw("AS")
                target = self._type_text()
                self.expect_op(")")
                return t.Cast(e, target, safe=(kw == "TRY_CAST"))
            if kw == "EXTRACT":
                self.next()
                self.expect_op("(")
                field = self.next().upper
                self.expect_kw("FROM")
                e = self.expression()
                self.expect_op(")")
                return t.Extract(field.lower(), e)
            if kw == "CASE":
                return self._case()
            if kw == "EXISTS":
                self.next()
                self.expect_op("(")
                q = self.query()
                self.expect_op(")")
                return t.Exists(q)
            if kw == "SUBSTRING":
                # SUBSTRING(x FROM a FOR b) or substring(x, a, b)
                self.next()
                self.expect_op("(")
                e = self.expression()
                if self.accept_kw("FROM"):
                    start = self.expression()
                    length = None
                    if self.accept_kw("FOR"):
                        length = self.expression()
                    self.expect_op(")")
                    args = (e, start) + ((length,) if length else ())
                    return t.FunctionCall("substr", args)
                args = [e]
                while self.accept_op(","):
                    args.append(self.expression())
                self.expect_op(")")
                return t.FunctionCall("substr", tuple(args))
            if kw in ("IF",):
                self.next()
                self.expect_op("(")
                cond = self.expression()
                self.expect_op(",")
                then = self.expression()
                default = None
                if self.accept_op(","):
                    default = self.expression()
                self.expect_op(")")
                whens = ((cond, then),)
                return t.Case(None, whens, default)
            if kw == "POSITION" and self.peek(1).kind == "OP" and self.peek(1).text == "(":
                # POSITION(needle IN haystack) -> strpos(haystack, needle)
                self.next()
                self.expect_op("(")
                needle = self._additive()
                self.expect_kw("IN")
                haystack = self.expression()
                self.expect_op(")")
                return t.FunctionCall("strpos", (haystack, needle))
            if kw in _NONRESERVED:
                pass  # fall through to identifier handling
            else:
                raise SqlSyntaxError(f"unexpected keyword {tok.text!r}", tok.line, tok.col)
        # typed literal with a non-keyword type name: DECIMAL '12.34'
        if (
            self.peek().kind == "IDENT"
            and self.peek().upper == "DECIMAL"
            and self.peek(1).kind == "STRING"
        ):
            self.next()
            s = self.next().text.strip()
            return t.Literal(s, "decimal")
        # ARRAY[e1, e2, ...] constructor
        if (
            self.peek().kind == "IDENT"
            and self.peek().upper == "ARRAY"
            and self.peek(1).kind == "OP"
            and self.peek(1).text == "["
        ):
            self.next()
            self.expect_op("[")
            items: list[t.Node] = []
            if not self.at_op("]"):
                items.append(self.expression())
                while self.accept_op(","):
                    items.append(self.expression())
            self.expect_op("]")
            return t.ArrayLiteral(tuple(items))
        # identifier, qualified name, or function call
        if self.peek().kind in ("IDENT", "QIDENT") or (
            self.peek().kind == "KW" and self.peek().upper in _NONRESERVED
        ):
            name = self.qualified_name()
            if self.at_op("(") :
                return self._function_call(".".join(name))
            if len(name) == 1 and name[0].lower() in _NILADIC:
                # current_date / current_timestamp etc. take no parens
                return t.FunctionCall(name[0].lower(), ())
            return t.Identifier(name)
        raise SqlSyntaxError(f"unexpected token {tok.text!r}", tok.line, tok.col)

    def _case(self) -> t.Node:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.expression()
        whens = []
        while self.accept_kw("WHEN"):
            cond = self.expression()
            self.expect_kw("THEN")
            result = self.expression()
            whens.append((cond, result))
        default = None
        if self.accept_kw("ELSE"):
            default = self.expression()
        self.expect_kw("END")
        return t.Case(operand, tuple(whens), default)

    def _function_call(self, name: str) -> t.Node:
        self.expect_op("(")
        distinct = False
        args: list[t.Node] = []
        if self.at_op("*"):
            self.next()
            self.expect_op(")")
            fc = t.FunctionCall(name.lower(), (t.Star(),))
            if self.at_kw("FILTER"):  # count(*) FILTER (WHERE ...)
                self.next()
                self.expect_op("(")
                self.expect_kw("WHERE")
                cond = self.expression()
                self.expect_op(")")
                fc = t.FunctionCall(fc.name, fc.args, fc.distinct, filter=cond)
            return self._maybe_over(fc)
        if not self.at_op(")"):
            if self.accept_kw("DISTINCT"):
                distinct = True
            else:
                self.accept_kw("ALL")
            args.append(self.expression())
            while self.accept_op(","):
                args.append(self.expression())
        self.expect_op(")")
        fc = t.FunctionCall(name.lower(), tuple(args), distinct=distinct)
        # FILTER (WHERE ...)
        if self.at_kw("FILTER"):
            self.next()
            self.expect_op("(")
            self.expect_kw("WHERE")
            cond = self.expression()
            self.expect_op(")")
            fc = t.FunctionCall(fc.name, fc.args, fc.distinct, filter=cond)
        return self._maybe_over(fc)

    def _maybe_over(self, fc: t.FunctionCall) -> t.Node:
        if not self.at_kw("OVER"):
            return fc
        self.next()
        self.expect_op("(")
        partition_by: list[t.Node] = []
        order_by: tuple[t.SortItem, ...] = ()
        frame = None
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            partition_by.append(self.expression())
            while self.accept_op(","):
                partition_by.append(self.expression())
        if self.at_kw("ORDER"):
            order_by = self._order_by()
        if self.at_kw("ROWS", "RANGE"):
            frame_type = self.next().upper
            bounds = []
            if self.accept_kw("BETWEEN"):
                bounds.append(self._frame_bound())
                self.expect_kw("AND")
                bounds.append(self._frame_bound())
            else:
                bounds.append(self._frame_bound())
                bounds.append("CURRENT ROW")
            frame = (frame_type, bounds[0], bounds[1])
        self.expect_op(")")
        return t.FunctionCall(
            fc.name, fc.args, fc.distinct,
            window=t.WindowSpec(tuple(partition_by), order_by, frame),
            filter=fc.filter,
        )

    def _frame_bound(self) -> str:
        if self.accept_kw("UNBOUNDED"):
            tok = self.next()
            return f"UNBOUNDED {tok.upper}"
        if self.accept_kw("CURRENT"):
            self.expect_kw("ROW")
            return "CURRENT ROW"
        n = self.next().text
        tok = self.next()
        return f"{n} {tok.upper}"

    def _type_text(self) -> str:
        parts = [self.next().text]
        if self.at_op("("):
            self.expect_op("(")
            parts.append("(")
            while not self.at_op(")"):
                parts.append(self.next().text)
            self.expect_op(")")
            parts.append(")")
        return "".join(parts)


# keywords that may appear as identifiers (column/table names, functions)
_NONRESERVED = {
    "YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND", "DATE", "TIME",
    "TIMESTAMP", "IF", "FILTER", "SHOW", "TABLES", "SCHEMAS", "CATALOGS",
    "COLUMNS", "SESSION", "ANALYZE", "OVER", "PARTITION", "RANGE", "ROWS",
    "ROW", "FIRST", "LAST", "NEXT", "ONLY", "VALUES", "SETS", "OFFSET",
    "SUBSTRING", "CURRENT", "GROUPING", "POSITION", "PREPARE",
    "EXECUTE", "DEALLOCATE", "START", "TRANSACTION", "COMMIT", "ROLLBACK",
}

_NILADIC = {"current_date", "current_timestamp", "localtimestamp", "now"}
