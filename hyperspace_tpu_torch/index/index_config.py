"""User-facing index specification.

Reference parity: index/IndexConfig.scala:28-166 — name + indexed columns +
included columns, case-insensitive equality and duplicate checks
(IndexConfig.scala:40-53), plus a fluent Builder (IndexConfig.scala:88-158).
"""

from __future__ import annotations

import dataclasses

from hyperspace_tpu_torch.exceptions import HyperspaceError


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    index_name: str
    indexed_columns: tuple[str, ...]
    included_columns: tuple[str, ...] = ()

    def __init__(self, index_name: str, indexed_columns, included_columns=()):
        object.__setattr__(self, "index_name", index_name)
        object.__setattr__(self, "indexed_columns", tuple(indexed_columns))
        object.__setattr__(self, "included_columns", tuple(included_columns))
        self._validate()

    def _validate(self) -> None:
        if not self.index_name.strip():
            raise HyperspaceError("index name cannot be empty")
        if self.index_name.strip().startswith("_"):
            # Underscore-prefixed directories under the system path are
            # metadata-plane state (the advisor ledger dir), invisible to
            # the catalog listing — an index named that way could never
            # be found again.
            raise HyperspaceError(
                f"index name {self.index_name!r} cannot start with '_' "
                "(reserved for metadata directories)"
            )
        if not self.indexed_columns:
            raise HyperspaceError("indexed columns cannot be empty")
        low_indexed = [c.lower() for c in self.indexed_columns]
        low_included = [c.lower() for c in self.included_columns]
        if len(set(low_indexed)) != len(low_indexed):
            raise HyperspaceError("duplicate indexed columns")
        if len(set(low_included)) != len(low_included):
            raise HyperspaceError("duplicate included columns")
        if set(low_indexed) & set(low_included):
            raise HyperspaceError("indexed and included columns overlap")

    @property
    def all_columns(self) -> list[str]:
        return list(self.indexed_columns) + list(self.included_columns)

    def __eq__(self, other) -> bool:
        """Case-insensitive equality (IndexConfig.scala:40-53)."""
        if not isinstance(other, IndexConfig):
            return NotImplemented
        return (
            self.index_name.lower() == other.index_name.lower()
            and [c.lower() for c in self.indexed_columns] == [c.lower() for c in other.indexed_columns]
            and sorted(c.lower() for c in self.included_columns)
            == sorted(c.lower() for c in other.included_columns)
        )

    def __hash__(self):
        return hash(
            (
                self.index_name.lower(),
                tuple(c.lower() for c in self.indexed_columns),
                tuple(sorted(c.lower() for c in self.included_columns)),
            )
        )

    class Builder:
        """Fluent builder (IndexConfig.scala:88-158)."""

        def __init__(self):
            self._name: str | None = None
            self._indexed: list[str] = []
            self._included: list[str] = []

        def index_name(self, name: str) -> "IndexConfig.Builder":
            if self._name is not None:
                raise HyperspaceError("index name is already set")
            if not name.strip():
                raise HyperspaceError("index name cannot be empty")
            self._name = name
            return self

        def indexed_columns(self, *cols: str) -> "IndexConfig.Builder":
            if self._indexed:
                raise HyperspaceError("indexed columns are already set")
            if not cols:
                raise HyperspaceError("indexed columns cannot be empty")
            self._indexed = list(cols)
            return self

        def included_columns(self, *cols: str) -> "IndexConfig.Builder":
            if self._included:
                raise HyperspaceError("included columns are already set")
            self._included = list(cols)
            return self

        def create(self) -> "IndexConfig":
            if self._name is None or not self._indexed:
                raise HyperspaceError("both index name and indexed columns are required")
            return IndexConfig(self._name, self._indexed, self._included)

    @staticmethod
    def builder() -> "IndexConfig.Builder":
        return IndexConfig.Builder()
