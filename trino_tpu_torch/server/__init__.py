"""Coordinator server: HTTP client protocol, query management, dispatch.

Reference layers L7-L9 (SURVEY.md §1): ``core/trino-main/.../server/``,
``.../dispatcher/``, ``.../execution/`` (QueryManager / state machines).
"""
