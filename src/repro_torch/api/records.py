"""JSON-serializable result records.

A copy of ``repro.api.records`` (the port imports nothing of ``repro``).

Every façade/sweep entry point returns ``Record`` objects (dicts with
attribute access) instead of bare dataclasses, so results can be dumped
straight to JSON for the CLI, the golden-diff tooling, and downstream
plotting without per-type serializers. ``Record.from_obj`` converts any of
the core analysis dataclasses (HFUPoint, AFDPlan, Verdict, …), coercing
numpy scalars to plain Python.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, List, Optional

import numpy as np


def _coerce(value: Any) -> Any:
    """Make a value JSON-serializable (numpy scalars/arrays, tuples, nan)."""
    if isinstance(value, (np.bool_,)):
        return bool(value)
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.ndarray):
        return [_coerce(v) for v in value.tolist()]
    if isinstance(value, (tuple, list)):
        return [_coerce(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _coerce(v) for k, v in value.items()}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {k: _coerce(v)
                for k, v in dataclasses.asdict(value).items()}
    if isinstance(value, float) and value != value:      # nan → null
        return None
    return value


class Record(dict):
    """A dict with attribute access and a ``to_json`` convenience."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    @classmethod
    def from_obj(cls, obj: Any, **extra: Any) -> "Record":
        """Build a Record from a dataclass instance (plus extra fields)."""
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            body = {f.name: _coerce(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        elif isinstance(obj, dict):
            body = {k: _coerce(v) for k, v in obj.items()}
        else:
            raise TypeError(f"cannot build a Record from {type(obj)!r}")
        body.update({k: _coerce(v) for k, v in extra.items()})
        return cls(body)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self, indent=indent, sort_keys=True)


def dump_records(records: Iterable[Record], path: Optional[str] = None,
                 indent: int = 2) -> str:
    """Serialize records to a JSON array; optionally write it to ``path``."""
    text = json.dumps([dict(r) for r in records], indent=indent,
                      sort_keys=True)
    if path is not None:
        with open(path, "w") as fh:
            fh.write(text + "\n")
    return text


def load_records(path: str) -> List[Record]:
    with open(path) as fh:
        return [Record(r) for r in json.load(fh)]
