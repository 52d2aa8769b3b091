"""Local stand-in for ``datasets.load_dataset`` and for the processors'
downloads (the port's machine has neither ``datasets`` nor a network).

A published dataset is read from JSON-lines exports under the processor's
``out_folder``, one file a split::

    {out_folder}/hub/{path}/{name or "default"}/{split}.jsonl

(``path`` as on the hub, e.g. ``kilt_tasks/nq/validation.jsonl``,
``castorini/odqa-wiki-corpora/wiki-all-6-3-tamber/train.jsonl``).  Each
line is one row in the dataset's published schema, as
``Dataset.to_json(path, lines=True)`` writes it on a machine that has the
dataset.  A file the JAX processors fetch from a URL is read from a local
copy named after the URL's last path component, under the same root
(``{out_folder}/hub/eli5-dev-kilt.jsonl``; a listing URL names a folder of
the listed files).  ``csv`` and ``json`` data files are read as given, with
the standard library.  A missing file raises ``FileNotFoundError`` naming
the path looked for and the hub name or URL; nothing reaches the network.
"""

from __future__ import annotations

import csv
import json
import os
from collections.abc import Iterator
from urllib.parse import urlparse

from bergen_tpu_torch.data.dataset import Dataset, concatenate_datasets

# the strings pandas' read_csv reads as missing values (its default
# ``na_values``): HF's csv loader reads through pandas
_CSV_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
           "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
           "None", "n/a", "nan", "null"}
_CSV_TRUE, _CSV_FALSE = {"True", "TRUE", "true"}, {"False", "FALSE", "false"}


def hub_root(out_folder: str) -> str:
    return os.path.join(out_folder, "hub")


def _missing(path: str, what: str) -> FileNotFoundError:
    return FileNotFoundError(
        f"{path} not found: the port reads {what} from local files only "
        "(export it as JSON lines on a machine that has it; README, "
        "'Local dataset exports')")


def iter_jsonl(path: str, what: str | None = None) -> Iterator[dict]:
    """The rows of a JSON-lines file (or of one JSON array), one at a
    time: a corpus is read line by line, never whole."""
    if not os.path.exists(path):
        raise _missing(path, what or path)
    with open(path, encoding="utf-8") as f:
        first = f.read(1)
        while first.isspace():
            first = f.read(1)
        f.seek(0)
        if first == "[":
            yield from json.load(f)
            return
        for line in f:
            if line.strip():
                yield json.loads(line)


def read_jsonl(path: str, what: str | None = None) -> list[dict]:
    return list(iter_jsonl(path, what))


def _csv_column(values: list[str]) -> list:
    """One column typed as pandas' ``read_csv`` types it, with a missing
    value as None (HF's ``from_pandas`` reads NaN as null): integers, else
    floats (integers too where a value is missing), else booleans, else
    strings."""
    present = [v for v in values if v not in _CSV_NA]

    def parses(cast) -> bool:
        try:
            for v in present:
                cast(v)
        except ValueError:
            return False
        return True

    if present and parses(int):
        cast = int if len(present) == len(values) else (lambda v: float(int(v)))
    elif present and parses(float):
        cast = float
    elif present and all(v in _CSV_TRUE | _CSV_FALSE for v in present):
        cast = _CSV_TRUE.__contains__
    else:
        cast = str
    return [None if v in _CSV_NA else cast(v) for v in values]


def read_csv(path: str, delimiter: str = ",",
             column_names: list[str] | None = None) -> Dataset:
    """A delimited file as ``pandas.read_csv(path, sep=delimiter,
    names=column_names)`` reads it: the first line is the header unless
    ``column_names`` are given."""
    if not os.path.exists(path):
        raise _missing(path, path)
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f, delimiter=delimiter))
    if column_names is None:
        column_names, rows = rows[0], rows[1:]
    cols = {name: _csv_column([r[i] if i < len(r) else "" for r in rows])
            for i, name in enumerate(column_names)}
    return Dataset(cols)


class HubDataset:
    """The splits of one exported hub dataset, each read when first asked
    for (``load_dataset(path, name)`` without a split)."""

    def __init__(self, folder: str, hub_name: str):
        self.folder = folder
        self.hub_name = hub_name
        self._splits: dict[str, Dataset] = {}

    def rows(self, split: str) -> Iterator[dict]:
        """The split's rows one at a time, none of them kept."""
        return iter_jsonl(os.path.join(self.folder, f"{split}.jsonl"),
                          f"hub dataset {self.hub_name!r}, split {split!r}")

    def __getitem__(self, split: str) -> Dataset:
        if split not in self._splits:
            self._splits[split] = Dataset.from_list(list(self.rows(split)))
        return self._splits[split]


def load_dataset(out_folder: str, path: str, name: str | None = None,
                 split: str | None = None, *, data_files=None,
                 delimiter: str = ",", column_names: list[str] | None = None,
                 **_ignored):
    """``datasets.load_dataset`` on local files: a hub dataset's export
    under ``out_folder`` (its ``split``, or all its splits), or ``csv`` /
    ``json`` ``data_files`` as given (one split, ``train``, as HF names
    it).  ``num_proc`` and ``trust_remote_code`` are ignored."""
    if path in ("csv", "json") and data_files is not None:
        files = [data_files] if isinstance(data_files, str) else data_files
        if path == "csv":
            ds = concatenate_datasets([read_csv(f, delimiter, column_names)
                                       for f in files])
        else:
            ds = Dataset.from_list([r for f in files for r in read_jsonl(f)])
        splits = {"train": ds}
        return splits[split] if split is not None else splits
    ds = hub_dataset(out_folder, path, name)
    return ds[split] if split is not None else ds


def hub_dataset(out_folder: str, path: str,
                name: str | None = None) -> HubDataset:
    """The exported splits of hub dataset ``path`` / ``name``."""
    return HubDataset(os.path.join(hub_root(out_folder), *path.split("/"),
                                   name or "default"),
                      path + (f", {name}" if name else ""))


def local_file(out_folder: str, url: str) -> str:
    """The local copy of a URL's file (or listed folder): its last path
    component under ``{out_folder}/hub``.  Raises naming both if absent."""
    base = os.path.basename(urlparse(url).path.rstrip("/"))
    path = os.path.join(hub_root(out_folder), base)
    if not os.path.exists(path):
        raise _missing(path, f"the file of {url}")
    return path
