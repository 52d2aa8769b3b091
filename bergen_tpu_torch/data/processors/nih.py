"""NIH needle-in-haystack processors (the PyTorch port's copy of
``bergen_tpu/data/processors/nih.py``; reference
``modules/processors/nih_dataset_processor.py``): naver/bergen_nih_v1
configs number / simple / multihop, each exposing a query or doc view, read
from their local exports (``data/hub.py``)."""

from __future__ import annotations

from bergen_tpu_torch.data.dataset import Dataset
from bergen_tpu_torch.data.processor import Processor


class NIHDataset(Processor):
    def __init__(self, config_name="number", is_query=True, *args, **kwargs):
        name = f"nih_v1_{config_name}" + ("_query" if is_query else "_doc")
        super().__init__(*args, **kwargs, dataset_name=name)
        self.conf_name = config_name
        self.is_query = is_query

    def process(self):
        ds = self.hub("naver/bergen_nih_v1", self.conf_name, self.split)
        if self.is_query:
            ds = ds.rename_columns({"qid": "id", "query": "content"})
            cols = ds.remove_columns(["did", "doc"]).to_dict()
            cols["label"] = [[str(x)] for x in cols["label"]]
            return Dataset(cols)
        ds = ds.rename_columns({"did": "id", "doc": "content"})
        return ds.remove_columns(["qid", "query", "label"])


class NIHDatasetNumber(NIHDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, config_name="number")


class NIHDatasetSimple(NIHDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, config_name="simple")


class NIHDatasetMultiHop(NIHDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs, config_name="multihop")
