"""Dataset processing layer (the PyTorch port's copy of
``bergen_tpu/data/processor.py``).

Every dataset (queries or documents) is normalised to a column store with the
schema the pipeline relies on (reference
``modules/dataset_processor.py:10-16``):

* ``id``      — str, unique example id
* ``content`` — str (question text / passage text)
* ``label``   — List[str], acceptable answers (query datasets only)
* ``ranking_label`` — optional provenance ids for retrieval eval

Processed datasets are cached as JSON (``columns.json`` plus an
``id2index.json`` side table) under ``{out_folder}/{name}_{split}``, in place
of the JAX package's HF ``save_to_disk`` + pickle, which need the
``datasets`` package.
"""

from __future__ import annotations

import json
import os
import random
from collections import defaultdict
from typing import Dict

from bergen_tpu_torch import confy
from bergen_tpu_torch.data import hub
from bergen_tpu_torch.data.dataset import Dataset, concatenate_datasets


class Processor:
    """Base processor: subclasses implement ``process() -> Dataset``; caching,
    debug subsetting, label shuffling and id2index live here (reference
    ``modules/dataset_processor.py:31-103``)."""

    def __init__(
        self,
        dataset_name: str,
        split: str,
        out_folder: str,
        num_proc: int,
        overwrite: bool,
        debug: bool,
        oracle_provenance: bool,
        shuffle_labels: bool,
    ) -> None:
        self.dataset_name = dataset_name
        self.split = split
        self.num_proc = num_proc
        self.out_folder = out_folder
        self.overwrite = overwrite
        self.debug = debug
        self.oracle_provenance = oracle_provenance
        self.shuffle_labels = shuffle_labels

    def process(self) -> Dataset:
        raise NotImplementedError

    def hub(self, path: str, name: str | None = None,
            split: str | None = None, **kwargs):
        """``datasets.load_dataset`` on the local exports under
        ``out_folder`` (``data/hub.py``)."""
        return hub.load_dataset(self.out_folder, path, name, split, **kwargs)

    def get_index_to_id(self, dataset: Dataset) -> Dict[str, int]:
        return dict(zip(dataset["id"], range(len(dataset))))

    def shuffled_labels_as_content(self, dataset: Dataset) -> Dataset:
        """Random-answer baseline: shuffle labels across queries, keep original
        first label as ranking_label (reference :67-74)."""
        random.seed(42)
        col = list(dataset["label"])
        random.shuffle(col)
        d = dataset.to_dict()
        d["ranking_label"] = [el[0] for el in col]
        return Dataset.from_dict(d)

    def get_dataset(self) -> Dataset:
        assert self.dataset_name is not None
        debug_str = "_debug" if self.debug else ""
        oracle_str = "_oracle_provenance" if self.oracle_provenance else ""
        out_folder = os.path.join(
            self.out_folder, f"{self.dataset_name}_{self.split}{oracle_str}"
        )
        id_file = os.path.join(out_folder, "id2index.json")
        if Dataset.on_disk(out_folder) and not self.overwrite:
            dataset = Dataset.load_from_disk(out_folder)
            with open(id_file) as f:
                id2index = json.load(f)
        else:
            dataset = self.process()
            dataset.save_to_disk(out_folder)
            id2index = self.get_index_to_id(dataset)
            with open(id_file, "w") as f:
                json.dump(id2index, f)
        if self.debug:
            dataset = dataset.select(range(min(len(dataset), 50)))
        if self.shuffle_labels:
            dataset = self.shuffled_labels_as_content(dataset)
        dataset.id2index = id2index
        dataset.name = self.dataset_name + debug_str + oracle_str
        return dataset


class MergedDocDataset(Processor):
    """Multi-corpus concat with id prefixing (reference :595-633): each
    input corpus must already be processed into the JSON cache under
    ``out_folder``; its ids become ``{name}_{id}``."""

    def __init__(self, out_dataset_name, in_dataset_names, in_dataset_splits,
                 *args, **kwargs):
        super().__init__(*args, **kwargs, dataset_name=out_dataset_name)
        if len(in_dataset_names) != len(in_dataset_splits):
            raise ValueError("in_dataset_names and in_dataset_splits differ "
                             "in length")
        self.in_dataset_names = in_dataset_names
        self.in_dataset_splits = in_dataset_splits

    def process(self):
        raise NotImplementedError(
            "Merge inputs must be preprocessed independently first."
        )

    def get_dataset(self):
        debug_str = "_debug" if self.debug else ""
        oracle_str = "_oracle_provenance" if self.oracle_provenance else ""
        loaded = []
        for name, split in zip(self.in_dataset_names, self.in_dataset_splits):
            in_folder = os.path.join(self.out_folder, f"{name}_{split}{oracle_str}")
            if not Dataset.on_disk(in_folder):
                raise ValueError(f"Dataset {in_folder} not found")
            cols = Dataset.load_from_disk(in_folder).to_dict()
            cols["id"] = [f"{name}_{i}" for i in cols["id"]]
            loaded.append(Dataset(cols))
        dataset = concatenate_datasets(loaded)
        dataset.id2index = self.get_index_to_id(dataset)
        if self.debug:
            dataset = dataset.select(range(50))
        if self.shuffle_labels:
            dataset = self.shuffled_labels_as_content(dataset)
        dataset.name = self.dataset_name + debug_str + oracle_str
        return dataset


class ProcessDatasets:
    """Instantiate & run all processors for a dataset config tree
    ``{split: {query: cfg, doc: cfg}}`` (reference :636-698)."""

    @staticmethod
    def _sanity_checks(dataset: Dataset) -> None:
        for example in dataset:
            for field, value in example.items():
                if value is None:
                    raise ValueError(f"None value in '{field}' field.")
                if isinstance(value, list) and None in value:
                    raise ValueError(f"None inside list in '{field}' field.")
                if isinstance(value, str) and len(value.strip()) == 0:
                    raise ValueError(f"Empty value in '{field}' field.")
                if isinstance(value, list) and len(value) == 0:
                    raise ValueError(f"Empty list in '{field}' field.")

    @staticmethod
    def process(dataset_config, out_folder="datasets", num_proc=1, overwrite=False,
                debug=False, oracle_provenance=False, shuffle_labels=False):
        out = defaultdict(dict)
        for split in dataset_config:
            for query_or_doc in dataset_config[split]:
                node = dataset_config[split][query_or_doc]
                if node is not None:
                    processor = confy.instantiate(
                        node["init_args"],
                        out_folder=out_folder,
                        num_proc=num_proc,
                        overwrite=overwrite,
                        debug=debug if query_or_doc == "query" else False,
                        oracle_provenance=(
                            oracle_provenance if query_or_doc == "doc" else False
                        ),
                        shuffle_labels=(
                            shuffle_labels if query_or_doc == "query" else False
                        ),
                    )
                    dataset = processor.get_dataset()
                    if query_or_doc == "query":
                        ProcessDatasets._sanity_checks(dataset)
                    out[split][query_or_doc] = dataset
                else:
                    out[split][query_or_doc] = None
        return out

    @staticmethod
    def check_instantiate(dataset_config, out_folder="datasets", num_proc=1,
                          overwrite=False, debug=False):
        for split in dataset_config:
            for query_or_doc in dataset_config[split]:
                node = dataset_config[split][query_or_doc]
                if node is not None:
                    confy.instantiate(
                        node["init_args"],
                        out_folder=out_folder,
                        num_proc=num_proc,
                        overwrite=overwrite,
                        debug=debug if query_or_doc == "query" else False,
                        oracle_provenance=False,
                        shuffle_labels=False,
                    )
        return True
