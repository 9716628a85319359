"""Record representations flowing through the select pipeline.

Equivalent of the reference's ``sql.Record`` interface
(``internal/s3select/sql/record.go``) with two concrete kinds: positional CSV
rows (with optional header names) and nested JSON documents.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .value import MISSING


class CSVRecord:
    __slots__ = ("values", "names", "index")

    def __init__(self, values: List[str], names: Optional[List[str]] = None):
        self.values = values
        self.names = names
        self.index: Dict[str, int] = {}
        if names:
            for i, n in enumerate(names):
                # first occurrence wins, like the reference's csv reader
                self.index.setdefault(n, i)

    def get(self, key: str) -> Any:
        if key.startswith("_") and key[1:].isdigit():
            i = int(key[1:]) - 1
            if 0 <= i < len(self.values):
                return self.values[i]
            return MISSING
        if key in self.index:
            i = self.index[key]
            return self.values[i] if i < len(self.values) else MISSING
        # case-insensitive fallback
        for n, i in self.index.items():
            if n.lower() == key.lower():
                return self.values[i] if i < len(self.values) else MISSING
        return MISSING

    def columns(self) -> List[str]:
        if self.names:
            return list(self.names)
        return [f"_{i + 1}" for i in range(len(self.values))]

    def star_values(self) -> List[Any]:
        return list(self.values)

    def as_dict(self) -> Dict[str, Any]:
        return dict(zip(self.columns(), self.values))


class JSONRecord:
    __slots__ = ("data",)

    def __init__(self, data: Any):
        self.data = data

    def get(self, key: str) -> Any:
        if isinstance(self.data, dict):
            if key in self.data:
                return self.data[key]
            for k, v in self.data.items():
                if k.lower() == key.lower():
                    return v
            return MISSING
        return MISSING

    def columns(self) -> List[str]:
        if isinstance(self.data, dict):
            return list(self.data.keys())
        return ["_1"]

    def star_values(self) -> List[Any]:
        if isinstance(self.data, dict):
            return list(self.data.values())
        return [self.data]

    def as_dict(self) -> Dict[str, Any]:
        if isinstance(self.data, dict):
            return self.data
        return {"_1": self.data}
