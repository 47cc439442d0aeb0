"""TOML config with dotted-path lookup.

Parity model: flowgger src/flowgger/config.rs:46-108 — a dumb,
untyped store; all validation lives in each component's constructor, which
raises ``ConfigError`` with the same messages the reference panics with.
"""

from __future__ import annotations

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: tomli is API-compatible
    import tomli as tomllib
from typing import Any, Optional


class ConfigError(Exception):
    """Equivalent of the reference's config-time panics."""


class Config:
    def __init__(self, table: dict):
        self._table = table

    @classmethod
    def from_path(cls, path: str) -> "Config":
        with open(path, "rb") as fd:
            data = fd.read()
        return cls.from_string(data.decode("utf-8"))

    @classmethod
    def from_string(cls, toml_text: str) -> "Config":
        try:
            table = tomllib.loads(toml_text)
        except (tomllib.TOMLDecodeError, UnicodeDecodeError):
            raise ConfigError("Syntax error - config file is not valid TOML")
        return cls(table)

    def lookup(self, path: str) -> Optional[Any]:
        """Dotted lookup, e.g. ``lookup("input.format")`` (config.rs:96-108).

        Reference quirk preserved: a non-table intermediate value is
        *skipped*, not rejected — the Rust loop only descends when the
        current value is a table and otherwise ignores the remaining path
        parts, so ``output = "file"`` makes ``lookup("output.file_path")``
        return ``"file"`` (config.rs:100-106).
        """
        cur: Any = self._table
        for part in path.split("."):
            if isinstance(cur, dict):
                if part not in cur:
                    return None
                cur = cur[part]
        return cur

    # -- typed helpers mirroring the reference's `expect()` call sites ----
    def lookup_str(self, path: str, err: str, default: Optional[str] = None) -> Optional[str]:
        v = self.lookup(path)
        if v is None:
            return default
        if not isinstance(v, str):
            raise ConfigError(err)
        return v

    def lookup_int(self, path: str, err: str, default: Optional[int] = None) -> Optional[int]:
        v = self.lookup(path)
        if v is None:
            return default
        if isinstance(v, bool) or not isinstance(v, int):
            raise ConfigError(err)
        return v

    def lookup_float(self, path: str, err: str, default: Optional[float] = None) -> Optional[float]:
        v = self.lookup(path)
        if v is None:
            return default
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ConfigError(err)
        return float(v)

    def lookup_bool(self, path: str, err: str, default: Optional[bool] = None) -> Optional[bool]:
        v = self.lookup(path)
        if v is None:
            return default
        if not isinstance(v, bool):
            raise ConfigError(err)
        return v

    def lookup_table(self, path: str, err: str) -> Optional[dict]:
        v = self.lookup(path)
        if v is None:
            return None
        if not isinstance(v, dict):
            raise ConfigError(err)
        return v
