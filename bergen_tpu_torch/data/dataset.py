"""A small column store standing in for HF ``datasets.Dataset``.

The port's machine has no ``datasets`` package.  The pipeline and the
dataset processors need only this much of it: named columns of equal
length, row and column access, ``features`` membership, ``add_column``,
renaming, removing and keeping columns (each returning a new dataset),
``select``, ``concatenate_datasets``, and a JSON round trip for the
processed-dataset cache.
``name`` and ``id2index`` are plain attributes that callers set, as they do
on HF datasets.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator


class Dataset:
    def __init__(self, columns: dict[str, list]):
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns differ in length: {lengths}")
        self._cols = {k: list(v) for k, v in columns.items()}
        self._n = lengths.pop() if lengths else 0
        self.name: str | None = None
        self.id2index: dict[str, int] | None = None

    @classmethod
    def from_dict(cls, columns: dict[str, list]) -> "Dataset":
        return cls(columns)

    @classmethod
    def from_list(cls, rows: list[dict]) -> "Dataset":
        keys: list[str] = []
        for row in rows:
            for k in row:
                if k not in keys:
                    keys.append(k)
        return cls({k: [row.get(k) for row in rows] for k in keys})

    @property
    def features(self) -> dict[str, None]:
        return dict.fromkeys(self._cols)

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[dict]:
        for i in range(self._n):
            yield {k: v[i] for k, v in self._cols.items()}

    def __getitem__(self, key: Any):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, int):
            return {k: v[key] for k, v in self._cols.items()}
        idx = list(key)
        return {k: [v[i] for i in idx] for k, v in self._cols.items()}

    def to_dict(self) -> dict[str, list]:
        return {k: list(v) for k, v in self._cols.items()}

    def add_column(self, name: str, values: list) -> "Dataset":
        if name in self._cols:
            raise ValueError(f"column {name!r} already exists")
        cols = self.to_dict()
        cols[name] = list(values)
        return Dataset(cols)

    def select(self, indices) -> "Dataset":
        idx = list(indices)
        return Dataset({k: [v[i] for i in idx] for k, v in self._cols.items()})

    @property
    def column_names(self) -> list[str]:
        return list(self._cols)

    def rename_columns(self, mapping: dict[str, str]) -> "Dataset":
        missing = set(mapping) - set(self._cols)
        if missing:
            raise ValueError(f"columns {sorted(missing)} not in the dataset")
        return Dataset({mapping.get(k, k): v for k, v in self._cols.items()})

    def rename_column(self, old: str, new: str) -> "Dataset":
        return self.rename_columns({old: new})

    def remove_columns(self, names) -> "Dataset":
        names = [names] if isinstance(names, str) else list(names)
        missing = set(names) - set(self._cols)
        if missing:
            raise ValueError(f"columns {sorted(missing)} not in the dataset")
        return Dataset({k: v for k, v in self._cols.items()
                        if k not in names})

    def select_columns(self, names) -> "Dataset":
        names = [names] if isinstance(names, str) else list(names)
        return Dataset({k: self._cols[k] for k in names})

    def save_to_disk(self, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        tmp = os.path.join(folder, "columns.json.tmp")
        with open(tmp, "w") as f:
            json.dump(self._cols, f)
        os.replace(tmp, os.path.join(folder, "columns.json"))

    @classmethod
    def load_from_disk(cls, folder: str) -> "Dataset":
        with open(os.path.join(folder, "columns.json")) as f:
            return cls(json.load(f))

    @staticmethod
    def on_disk(folder: str) -> bool:
        return os.path.exists(os.path.join(folder, "columns.json"))


def concatenate_datasets(parts: list[Dataset]) -> Dataset:
    """Rows of ``parts`` in order; every part has the same columns."""
    names = parts[0].column_names
    for p in parts[1:]:
        if set(p.column_names) != set(names):
            raise ValueError(f"columns differ: {names} and {p.column_names}")
    return Dataset({k: [x for p in parts for x in p[k]] for k in names})
