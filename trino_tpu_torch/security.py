"""Access control.

Reference: ``core/trino-main/.../security/AccessControlManager.java``
multiplexing system + connector access controls, and the file-based
system access control of ``lib/trino-plugin-toolkit``
(``FileBasedSystemAccessControl``: catalog/schema/table rules with user
regex matching). The port's copy of ``trino_tpu/security.py``.

The engine consults ``check_can_select`` / ``check_can_insert`` /
``check_can_drop`` before executing; the default control allows all
(reference: ``AllowAllSystemAccessControl``)."""

from __future__ import annotations

import dataclasses
import re
from typing import Optional


class AccessDeniedError(Exception):
    def __init__(self, what: str):
        super().__init__(f"Access Denied: {what}")


@dataclasses.dataclass
class CatalogRule:
    """One rule of a file-based policy: first match wins."""

    user_pattern: str = ".*"
    catalog_pattern: str = ".*"
    allow: str = "all"  # all | read-only | none

    def matches(self, user: str, catalog: str) -> bool:
        return bool(
            re.fullmatch(self.user_pattern, user or "")
            and re.fullmatch(self.catalog_pattern, catalog or "")
        )


class AccessControl:
    """allow-all base (AllowAllSystemAccessControl)."""

    def check_can_select(self, user: str, catalog: str, schema: str, table: str):
        pass

    def check_can_insert(self, user: str, catalog: str, schema: str, table: str):
        pass

    def check_can_create(self, user: str, catalog: str, schema: str, table: str):
        pass

    def check_can_drop(self, user: str, catalog: str, schema: str, table: str):
        pass

    def filter_catalogs(self, user: str, catalogs: list[str]) -> list[str]:
        return catalogs


class FileBasedAccessControl(AccessControl):
    """Rules in the shape of the reference's rules.json:
    {"catalogs": [{"user": "...", "catalog": "...", "allow": "all|read-only|none"}]}
    First matching rule wins; no match denies (reference behavior)."""

    def __init__(self, config: dict):
        self.rules = [
            CatalogRule(
                r.get("user", ".*"), r.get("catalog", ".*"), r.get("allow", "none")
            )
            for r in config.get("catalogs", [])
        ]

    def _allow(self, user: str, catalog: str) -> str:
        for rule in self.rules:
            if rule.matches(user, catalog):
                return rule.allow
        return "none"

    def check_can_select(self, user, catalog, schema, table):
        if self._allow(user, catalog) == "none":
            raise AccessDeniedError(f"Cannot select from {catalog}.{schema}.{table}")

    def check_can_insert(self, user, catalog, schema, table):
        if self._allow(user, catalog) != "all":
            raise AccessDeniedError(f"Cannot insert into {catalog}.{schema}.{table}")

    def check_can_create(self, user, catalog, schema, table):
        if self._allow(user, catalog) != "all":
            raise AccessDeniedError(f"Cannot create {catalog}.{schema}.{table}")

    def check_can_drop(self, user, catalog, schema, table):
        if self._allow(user, catalog) != "all":
            raise AccessDeniedError(f"Cannot drop {catalog}.{schema}.{table}")

    def filter_catalogs(self, user, catalogs):
        return [c for c in catalogs if self._allow(user, c) != "none"]


class AccessControlManager(AccessControl):
    """Chains system access controls; every control must allow
    (AccessControlManager semantics)."""

    def __init__(self):
        self._controls: list[AccessControl] = []
        # bumped whenever policy changes; cached query plans embed the
        # generation so a policy change invalidates plan-time checks
        self.generation = 0

    def add(self, control: AccessControl) -> None:
        self._controls.append(control)
        self.generation += 1

    def check_can_select(self, user, catalog, schema, table):
        for c in self._controls:
            c.check_can_select(user, catalog, schema, table)

    def check_can_insert(self, user, catalog, schema, table):
        for c in self._controls:
            c.check_can_insert(user, catalog, schema, table)

    def check_can_create(self, user, catalog, schema, table):
        for c in self._controls:
            c.check_can_create(user, catalog, schema, table)

    def check_can_drop(self, user, catalog, schema, table):
        for c in self._controls:
            c.check_can_drop(user, catalog, schema, table)

    def filter_catalogs(self, user, catalogs):
        for c in self._controls:
            catalogs = c.filter_catalogs(user, catalogs)
        return catalogs
