"""A small column store standing in for HF ``datasets.Dataset``.

The port's machine has no ``datasets`` package.  The pipeline needs only
this much of it: named columns of equal length, row and column access,
``features`` membership, ``add_column`` returning a new dataset, ``select``,
and a JSON round trip for the processed-dataset cache.
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
