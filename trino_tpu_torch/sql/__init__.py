"""SQL frontend: lexer, parser, AST.

Reference: ``core/trino-parser`` (ANTLR4 grammar ``SqlBase.g4``, 197 AST
classes). Here: a hand-rolled lexer + Pratt parser covering the
TPC-H/TPC-DS-class SQL subset, producing a compact AST.
"""

from trino_tpu_torch.sql.parser import parse_statement  # noqa: F401
