"""SQL lexer.

Reference: the lexical rules of ``core/trino-parser/src/main/antlr4/io/trino/sql/parser/SqlBase.g4``
(identifiers, quoted identifiers, string literals with '' escape, numbers,
comments). Keywords are recognized case-insensitively; non-reserved words
may still be identifiers (handled in the parser).
"""

from __future__ import annotations

import dataclasses


class SqlSyntaxError(Exception):
    def __init__(self, message: str, line: int = 0, col: int = 0):
        super().__init__(f"line {line}:{col}: {message}" if line else message)
        self.line = line
        self.col = col


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # IDENT, QIDENT, STRING, NUMBER, OP, KW, EOF
    text: str
    line: int
    col: int

    @property
    def upper(self) -> str:
        return self.text.upper()


KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "AS", "AND", "OR", "NOT", "IN", "EXISTS", "BETWEEN", "LIKE", "ESCAPE",
    "IS", "NULL", "TRUE", "FALSE", "CASE", "WHEN", "THEN", "ELSE", "END",
    "CAST", "TRY_CAST", "EXTRACT", "JOIN", "INNER", "LEFT", "RIGHT", "FULL",
    "OUTER", "CROSS", "ON", "USING", "UNION", "ALL", "DISTINCT", "EXCEPT",
    "INTERSECT", "WITH", "RECURSIVE", "ASC", "DESC", "NULLS", "FIRST",
    "LAST", "INTERVAL", "DATE", "TIME", "TIMESTAMP", "YEAR", "MONTH", "DAY",
    "HOUR", "MINUTE", "SECOND", "OVER", "PARTITION", "ROWS", "RANGE",
    "UNBOUNDED", "PRECEDING", "FOLLOWING", "CURRENT", "ROW", "VALUES",
    "INSERT", "INTO", "CREATE", "TABLE", "DROP", "DELETE", "UPDATE", "SET",
    "SHOW", "DESCRIBE", "EXPLAIN", "ANALYZE", "SUBSTRING", "FOR", "OFFSET",
    "FETCH", "NEXT", "ONLY", "GROUPING", "SETS", "ROLLUP", "CUBE", "IF",
    "SESSION", "TABLES", "SCHEMAS", "CATALOGS", "COLUMNS", "FILTER",
    "PREPARE", "EXECUTE", "DEALLOCATE", "ANY", "SOME", "POSITION",
    "START", "TRANSACTION", "COMMIT", "ROLLBACK",
}

_MULTI_OPS = ("<>", "<=", ">=", "!=", "||")
_SINGLE_OPS = "+-*/%(),.;<>=[]?"


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    i, n = 0, len(sql)
    line, col = 1, 1

    def advance(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and sql[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        ch = sql[i]
        if ch in " \t\r\n":
            advance(1)
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            advance((j - i) if j >= 0 else (n - i))
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SqlSyntaxError("unterminated block comment", line, col)
            advance(j + 2 - i)
            continue
        start_line, start_col = line, col
        if ch == "'":
            # string literal, '' escapes a quote
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlSyntaxError("unterminated string", start_line, start_col)
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token("STRING", "".join(buf), start_line, start_col))
            advance(j + 1 - i)
            continue
        if ch == '"':
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlSyntaxError("unterminated quoted identifier", start_line, start_col)
                if sql[j] == '"':
                    if j + 1 < n and sql[j + 1] == '"':
                        buf.append('"')
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token("QIDENT", "".join(buf), start_line, start_col))
            advance(j + 1 - i)
            continue
        if ch.isdigit() or (ch == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                c = sql[j]
                if c.isdigit():
                    j += 1
                elif c == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif c in "eE" and not seen_exp and j > i:
                    if j + 1 < n and (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                        seen_exp = True
                        j += 2 if sql[j + 1] in "+-" else 1
                    else:
                        break
                else:
                    break
            tokens.append(Token("NUMBER", sql[i:j], start_line, start_col))
            advance(j - i)
            continue
        if ch.isalpha() or ch == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            text = sql[i:j]
            kind = "KW" if text.upper() in KEYWORDS else "IDENT"
            tokens.append(Token(kind, text, start_line, start_col))
            advance(j - i)
            continue
        matched = False
        for op in _MULTI_OPS:
            if sql.startswith(op, i):
                tokens.append(Token("OP", op, start_line, start_col))
                advance(len(op))
                matched = True
                break
        if matched:
            continue
        if ch in _SINGLE_OPS:
            tokens.append(Token("OP", ch, start_line, start_col))
            advance(1)
            continue
        raise SqlSyntaxError(f"unexpected character {ch!r}", line, col)
    tokens.append(Token("EOF", "", line, col))
    return tokens
