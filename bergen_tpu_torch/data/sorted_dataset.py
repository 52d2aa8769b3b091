"""Length-sorted tokenized dataset (the PyTorch port's counterpart of
``bergen_tpu/data/sorted_dataset.py``, the reference's
``Tokenized_Sorted_Dataset``): formats every instruction once, measures
its token length, and yields the items sorted by length.

Neither package's trainer uses it (``train/trainer.py`` batches its rows
itself, as JAX's does); it is kept for callers of the reference's class."""

from __future__ import annotations

from typing import List


class TokenizedSortedDataset:
    def __init__(self, data, model, training: bool = False):
        self.model = model
        self.training = training
        rows: List[tuple] = []
        for item in data:
            item = dict(item)
            formatted, label_start = model.format_instruction(
                item, eval=not training)
            item["formatted_instruction"] = formatted
            item["label_start_index"] = label_start
            if model.tokenizer is not None:
                n = len(model.tokenizer(formatted,
                                        truncation=False)["input_ids"])
            else:
                n = len(formatted.split())
            rows.append((n, item))
        rows.sort(key=lambda r: r[0])
        self.sorted_data = rows

    def __len__(self) -> int:
        return len(self.sorted_data)

    def __getitem__(self, idx: int) -> dict:
        return self.sorted_data[idx][1]

    def __iter__(self):
        for _, item in self.sorted_data:
            yield item

    def select(self, indices):
        out = TokenizedSortedDataset([], self.model, self.training)
        out.sorted_data = [self.sorted_data[i] for i in indices]
        return out
