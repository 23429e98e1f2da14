"""PETSc-style options database.

Re-imagines the reference's global string-keyed options DB
(reference: src/sys/objects/options.c — PetscOptionsInsert :592,
PetscOptionsGetInt :1356) as an explicit, prefix-scoped dict with
used/unused tracking (the `-options_left` feature) so recursive solver
composition ("-mg_levels_ksp_type chebyshev") works the same way:
every component consumes options under its own prefix via
``opts.prefixed("mg_levels_")``.

Keys are stored WITHOUT a leading dash. Values are strings, numbers,
bools, or None (flag present with no value, i.e. boolean true).
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

_TRUE = {"true", "yes", "on", "1", ""}
_FALSE = {"false", "no", "off", "0"}


class Options:
    """A prefix-scoped options database.

    A root ``Options`` owns the dict; ``prefixed()`` returns a view whose
    gets/sets prepend the prefix. Queried keys are tracked so that
    ``unused()`` reports options that no component consumed (the
    reference's -options_left check).
    """

    def __init__(self, mapping: Optional[dict] = None, _parent: "Options" = None,
                 _prefix: str = ""):
        if _parent is None:
            self._d: dict = {}
            self._used: set = set()
            self._queried: dict = {}     # full key -> (type, default)
            self._root: Options = self
        else:
            self._root = _parent._root
        self._prefix = _prefix
        if mapping:
            for k, v in mapping.items():
                self.set(k, v)

    # -- construction -------------------------------------------------
    @classmethod
    def from_args(cls, args: Iterable[str]) -> "Options":
        """Parse a PETSc-style argv list: ["-ksp_type","gmres","-ksp_monitor"]."""
        o = cls()
        args = list(args)
        i = 0
        while i < len(args):
            a = args[i]
            if not a.startswith("-"):
                raise ValueError(f"expected option starting with '-', got {a!r}")
            key = a.lstrip("-")
            if i + 1 < len(args) and not args[i + 1].startswith("-"):
                o.set(key, args[i + 1])
                i += 2
            else:
                o.set(key, None)  # bare flag
                i += 1
        return o

    # -- core ----------------------------------------------------------
    def _full(self, key: str) -> str:
        return self._prefix + key

    def set(self, key: str, value: Any = None) -> "Options":
        self._root._d[self._full(key.lstrip("-"))] = value
        return self

    def update(self, mapping: dict) -> "Options":
        for k, v in mapping.items():
            self.set(k, v)
        return self

    def has(self, key: str) -> bool:
        full = self._full(key)
        if full in self._root._d:
            self._root._used.add(full)
            return True
        return False

    def get(self, key: str, default: Any = None) -> Any:
        full = self._full(key)
        if full in self._root._d:
            self._root._used.add(full)
            return self._root._d[full]
        return default

    def _record(self, key: str, kind: str, default) -> None:
        self._root._queried.setdefault(self._full(key), (kind, default))

    # -- typed getters (reference: PetscOptionsGetInt/Real/Bool/String) --
    def get_int(self, key: str, default: int = 0) -> int:
        self._record(key, "int", default)
        v = self.get(key, default)
        return int(v)

    def get_real(self, key: str, default: float = 0.0) -> float:
        self._record(key, "real", default)
        v = self.get(key, default)
        return float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        self._record(key, "bool", default)
        full = self._full(key)
        if full not in self._root._d:
            return default
        self._root._used.add(full)
        v = self._root._d[full]
        if v is None:
            return True
        if isinstance(v, bool):
            return v
        s = str(v).strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise ValueError(f"cannot interpret {v!r} as bool for -{full}")

    def get_str(self, key: str, default: str = "") -> str:
        self._record(key, "str", default)
        v = self.get(key, default)
        return str(v) if v is not None else default

    # -- prefix scoping --------------------------------------------------
    def prefixed(self, prefix: str) -> "Options":
        """Return a view of this database under an additional prefix."""
        return Options(_parent=self, _prefix=self._prefix + prefix)

    @property
    def prefix(self) -> str:
        return self._prefix

    # -- diagnostics -------------------------------------------------------
    def unused(self) -> list:
        """Keys set but never queried (reference: -options_left)."""
        return sorted(k for k in self._root._d if k not in self._root._used)

    def help_text(self) -> str:
        """The -help analog: every option any component queried from
        this database, with type, default, and current value (the
        reference's self-documenting PetscOptionsBegin/End blocks,
        aoptions.c:25 — here documentation is recorded at consumption
        time, so it is always complete for the configuration built)."""
        lines = ["Options consumed (type, default, current):"]
        for k in sorted(self._root._queried):
            kind, default = self._root._queried[k]
            cur = self._root._d.get(k, "<default>")
            lines.append(f"  -{k:42s} <{kind}> default={default!r} "
                         f"current={cur!r}")
        return "\n".join(lines)

    def items(self):
        return self._root._d.items()

    def __repr__(self):
        return f"Options(prefix={self._prefix!r}, db={self._root._d!r})"
