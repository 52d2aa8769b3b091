"""RAG orchestrator (the PyTorch port's counterpart of ``bergen_tpu/rag.py``).

Holds the stage objects, enforces ``generation_top_k <= rerank_top_k <=
retrieve_top_k``, caches every stage artifact under the JAX package's
deterministic filenames (TREC runs, generated queries, processed contexts),
evaluates rankings against qrels, and writes the per-experiment
``eval_{split}_out.json`` / ``eval_{split}_metrics.json``.  Ported:
``eval()`` with query generation, retrieval, cross-encoder reranking,
context processing and generation, and ``train()``: generator fine-tuning
over the retrieved contexts (``train/trainer.py``).  Every stage runs on
``device`` (default ``cuda``).

Under ``torchrun`` every rank builds the retriever, the reranker, the
query generator and the generator, and joins the retrieve and rerank
stages, which run data-parallel over the mesh's ``data`` axis (the
encoders split each batch, the corpus is sharded, ``pipeline/
retrieve.py``); the generator runs on its model rows (``tp`` ranks each,
``world / tp`` rows generating the same batch, as JAX's generator takes
its inputs unsharded).  Every rank also builds the context processor and
joins the context stage, whose encoders (RECOMP's, DSLR's) split their
batches over the ranks too.  Rank 0 alone processes the datasets (the
other ranks then read the columns it wrote: a processor is never re-run,
as MKQA's rows and ASQA's labels follow the hash seed), decides whether a
cached run, index, rewritten-query or processed-context file is used,
runs a query rewrite on a model of its own (NLLB; a rewrite on the
pipeline's generator runs on every rank, as the generator's slices do)
and hands its output to every rank, and writes every file: runs,
indexes, metrics, ``eval_*_out.json``, ``train_history.json`` and the
experiment folder, named as in one process.  The train stage runs on
every rank (``train/trainer.py``: a tensor-parallel generator trains its
slices).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time

import numpy as np

from bergen_tpu_torch import confy, utils
from bergen_tpu_torch import device as _device
from bergen_tpu_torch.data.processor import ProcessDatasets
from bergen_tpu_torch.metrics import RAGMetrics
from bergen_tpu_torch.parallel import mesh as _mesh
from bergen_tpu_torch.pipeline.generate_query import GenerateQueries
from bergen_tpu_torch.pipeline.process_context import ProcessContext
from bergen_tpu_torch.pipeline.rerank import Rerank
from bergen_tpu_torch.pipeline.retrieve import Retrieve


class RAG:
    def __init__(
        self,
        generator=None,
        retriever=None,
        reranker=None,
        query_generator=None,
        context_processor=None,
        runs_folder=None,
        run_name=None,
        dataset=None,
        processing_num_proc=1,
        dataset_folder="datasets/",
        index_folder="indexes/",
        generated_query_folder="generated_queries/",
        processed_context_folder="processed_contexts/",
        experiments_folder="experiments/",
        qrels_folder="qrels/",
        overwrite_datasets=False,
        overwrite_exp=False,
        overwrite_index=False,
        retrieve_top_k=1,
        rerank_top_k=1,
        generation_top_k=1,
        pyserini_num_threads=1,
        config=None,
        debug=False,
        continue_batch=None,
        train=None,
        prompt=None,
        device=None,
        **kwargs,
    ):
        cfg = config or {}
        retriever = retriever if retriever is not None else cfg.get("retriever")
        reranker = reranker if reranker is not None else cfg.get("reranker")
        generator = generator if generator is not None else cfg.get("generator")
        query_generator = (
            query_generator if query_generator is not None
            else cfg.get("query_generator")
        )
        context_processor = (
            context_processor if context_processor is not None
            else cfg.get("context_processor")
        )
        dataset = dataset if dataset is not None else cfg.get("dataset")
        if query_generator is None:
            query_generator = {
                "init_args": {
                    "_target_": "bergen_tpu.models.query_generators.copy.CopyQuery"
                }
            }

        self.training_config = train
        self.device = _device.resolve(device)
        # under torchrun every rank joins the stages; rank 0 writes
        self.rank = _mesh.rank()
        self.debug = debug
        self.dataset_folder = dataset_folder
        self.experiments_folder = experiments_folder
        self.runs_folder = runs_folder
        self.generated_query_folder = generated_query_folder
        self.processed_context_folder = processed_context_folder
        self.qrels_folder = qrels_folder
        self.processing_num_proc = processing_num_proc
        self.index_folder = index_folder
        self.config = config
        self.retrieve_top_k = retrieve_top_k
        self.rerank_top_k = rerank_top_k
        self.generation_top_k = generation_top_k
        self.pyserini_num_threads = pyserini_num_threads
        self.overwrite_exp = overwrite_exp
        self.overwrite_index = overwrite_index
        self.oracle_provenance = (
            retriever is not None
            and retriever["init_args"].get("model_name") == "oracle_provenance"
        )

        assert self.generation_top_k <= self.rerank_top_k <= self.retrieve_top_k

        lead = self.rank == 0
        self.run_name, self.experiment_folder = _mesh.broadcast_object(
            utils.init_experiment(
                config, experiments_folder, index_folder, runs_folder,
                run_name, overwrite_exp=overwrite_exp,
                continue_batch=continue_batch) if lead else None)

        shuffle_labels = (
            generator is not None
            and generator["init_args"].get("model_name") == "random_answer"
        )
        if not lead:  # the columns rank 0 processed and wrote
            _mesh.barrier()
        self.datasets = ProcessDatasets.process(
            dataset,
            out_folder=dataset_folder,
            num_proc=processing_num_proc,
            overwrite=overwrite_datasets and lead,
            debug=debug,
            shuffle_labels=shuffle_labels,
            oracle_provenance=self.oracle_provenance,
        )
        if lead:
            _mesh.barrier()
        self.metrics = {"train": RAGMetrics, "dev": RAGMetrics, "test": None}

        self.retriever = (
            Retrieve(
                **retriever,
                pyserini_num_threads=pyserini_num_threads,
                continue_batch=continue_batch,
                device=self.device,
            )
            if retriever is not None
            else None
        )
        self.reranker = (Rerank(**reranker, device=self.device)
                         if reranker is not None else None)
        self.generator = (
            confy.instantiate(generator["init_args"], prompt=prompt,
                              device=self.device)
            if generator is not None
            else None
        )
        self.query_generator = GenerateQueries(
            generator=self.generator, **query_generator, device=self.device
        )
        self.context_processor = (
            ProcessContext(**context_processor, device=self.device)
            if context_processor is not None
            else None
        )

    # ------------------------------------------------------------------ #

    def eval(self, dataset_split: str) -> None:
        lead = self.rank == 0
        dataset = self.datasets[dataset_split]
        query_dataset_name = dataset["query"].name
        doc_dataset_name = (
            dataset["doc"].name if dataset.get("doc") is not None else None
        )
        timer = utils.StageTimer()

        with (utils.maybe_profile(self.experiment_folder) if lead
              else contextlib.nullcontext()):
            if self.retriever is not None:
                with timer.track("generate_query"):
                    dataset = self.generate_query(
                        dataset, query_dataset_name, dataset_split
                    )
                with timer.track("retrieve"):
                    query_ids, doc_ids, _ = self.retrieve(
                        dataset, query_dataset_name, doc_dataset_name,
                        dataset_split, self.retrieve_top_k,
                    )
            else:
                query_ids, doc_ids = None, None

            if self.reranker is not None and doc_ids is not None:
                with timer.track("rerank"):
                    query_ids, doc_ids, _ = self.rerank(
                        dataset, query_dataset_name, doc_dataset_name,
                        dataset_split, query_ids, doc_ids, self.rerank_top_k,
                    )

            if doc_ids is not None:
                doc_ids = [d[: self.generation_top_k] for d in doc_ids]

            gen_dataset = utils.prepare_dataset_from_ids(
                dataset, query_ids, doc_ids, multi_doc=True,
                query_field="content", oracle_provenance=self.oracle_provenance,
            )

            if self.context_processor is not None and self.retriever is not None:
                with timer.track("process_context"):
                    gen_dataset = self.process_context(
                        gen_dataset, query_dataset_name, doc_dataset_name,
                        dataset_split,
                    )
            # every rank generates from rank 0's rows
            gen_dataset = _mesh.broadcast_object(gen_dataset if lead
                                                 else None)

            if self.generator is not None and not lead:
                # this rank's part of generating; rank 0 writes
                self.generator.eval(gen_dataset)
            elif self.generator is not None:
                with timer.track("generate"):
                    questions, _, predictions, references = self.generate(
                        gen_dataset, dataset_split
                    )
                with timer.track("metrics"):
                    self.eval_metrics(
                        dataset_split, questions, predictions, references
                    )

        if lead:
            timer.write(self.experiment_folder, dataset_split)
            utils.move_finished_experiment(self.experiment_folder)

    # ------------------------------------------------------------------ #

    def generate_query(self, dataset, query_dataset_name, dataset_split):
        id2index = dataset["query"].id2index
        if self.query_generator.get_clean_model_name() == "copy":
            dataset["query"] = dataset["query"].add_column(
                "generated_query", dataset["query"]["content"]
            )
        else:
            fname = utils.get_query_generation_filename(
                self.generated_query_folder, query_dataset_name,
                self.query_generator.get_clean_model_name(), dataset_split,
            )
            # rank 0 decides whether to rewrite or read its file, for every
            # rank; a rewrite on the pipeline's generator (set_generator)
            # runs on every rank, as that generator's slices do; one on a
            # model of its own (NLLB) on rank 0 alone; rank 0 writes
            lead, generated = self.rank == 0, None
            rewrite = _mesh.broadcast_object(lead and (
                not os.path.exists(fname) or self.overwrite_exp
                or self.overwrite_index))
            shared = hasattr(self.query_generator.model, "set_generator")
            if rewrite and (lead or shared):
                generated = self.query_generator.eval(dataset["query"])
            if rewrite and lead:
                os.makedirs(self.generated_query_folder, exist_ok=True)
                with open(fname, "w") as fp:
                    json.dump({"generated_queries": generated}, fp)
            elif lead:
                with open(fname) as fp:
                    generated = json.load(fp)["generated_queries"]
            dataset["query"] = dataset["query"].add_column(
                "generated_query", _mesh.broadcast_object(generated)
            )
            if lead:
                shutil.copyfile(fname, os.path.join(
                    self.experiment_folder, os.path.basename(fname)))
        dataset["query"].id2index = id2index
        return dataset

    def retrieve(self, dataset, query_dataset_name, doc_dataset_name,
                 dataset_split, retrieve_top_k, eval_ranking=True):
        if self.oracle_provenance and "doc" in dataset["query"].features:
            return dataset["query"]["id"], None, None

        ranking_file = utils.get_ranking_filename(
            self.runs_folder, query_dataset_name, doc_dataset_name,
            self.retriever.get_clean_model_name(), dataset_split,
            retrieve_top_k, self.query_generator.get_clean_model_name(),
        )
        doc_path = utils.get_index_path(
            self.index_folder, doc_dataset_name,
            self.retriever.get_clean_model_name(), "doc",
        )
        query_path = utils.get_index_path(
            self.index_folder, query_dataset_name,
            self.retriever.get_clean_model_name(), "query",
            dataset_split=dataset_split,
            query_generator_name=self.query_generator.get_clean_model_name(),
        )
        lead = self.rank == 0
        # rank 0 decides, for every rank, whether the run file serves
        if _mesh.broadcast_object(lead and (
                not os.path.exists(ranking_file) or self.overwrite_exp
                or self.overwrite_index)):
            out = self.retriever.retrieve(
                dataset, query_path, doc_path, retrieve_top_k
            )
            query_ids, doc_ids, scores = out["q_id"], out["doc_id"], out["score"]
            scores = scores.tolist() if hasattr(scores, "tolist") else scores
            if lead:
                utils.write_trec(ranking_file, query_ids, doc_ids, scores)
            if "fidelity" in out and lead:
                # every approximate/quantized run documents its own measured
                # approximation error (top-k overlap vs host fp32 exact)
                with open(os.path.join(
                    self.experiment_folder,
                    f"eval_{dataset_split}_retrieval_fidelity.json",
                ), "w") as f:
                    json.dump(out["fidelity"], f, indent=2)
        else:
            query_ids, doc_ids, scores = _mesh.broadcast_object(
                utils.load_trec(ranking_file) if lead else None)
        if not lead:
            return query_ids, doc_ids, scores
        shutil.copyfile(
            ranking_file,
            os.path.join(self.experiment_folder, os.path.basename(ranking_file)),
        )
        if eval_ranking and "ranking_label" in self.datasets[dataset_split]["query"].features:
            doc_ds = self.datasets[dataset_split]["doc"]
            wiki_ids = (
                [utils.get_by_id(doc_ds, d, "wikipedia_id") for d in doc_ids]
                if "wikipedia_id" in doc_ds.features
                else doc_ids
            )
            utils.eval_retrieval_kilt(
                self.experiment_folder, self.qrels_folder, query_dataset_name,
                doc_dataset_name, dataset_split, query_ids, wiki_ids, scores,
                top_k=self.generation_top_k, debug=self.debug,
            )
        return query_ids, doc_ids, scores

    def rerank(self, dataset, query_dataset_name, doc_dataset_name,
               dataset_split, query_ids, doc_ids, rerank_top_k):
        if self.oracle_provenance and "doc" in dataset["query"].features:
            return dataset["query"]["id"], None, None

        doc_ids = [d[:rerank_top_k] for d in doc_ids]
        reranking_file = utils.get_reranking_filename(
            self.runs_folder, query_dataset_name, doc_dataset_name,
            dataset_split, self.retriever.get_clean_model_name(),
            self.retrieve_top_k, self.reranker.get_clean_model_name(),
            self.rerank_top_k, self.query_generator.get_clean_model_name(),
        )
        lead = self.rank == 0
        if _mesh.broadcast_object(lead and (
                not os.path.exists(reranking_file) or self.overwrite_exp)):
            rerank_dataset = utils.prepare_dataset_from_ids(
                dataset, query_ids, doc_ids, multi_doc=False,
                query_field="generated_query",
            )
            out = self.reranker.eval(rerank_dataset)
            query_ids, doc_ids, scores = out["q_id"], out["doc_id"], out["score"]
            if lead:
                utils.write_trec(reranking_file, query_ids, doc_ids, scores)
            rr_fid = getattr(self.reranker.model, "w8a8_fidelity", None)
            if rr_fid is not None and lead:
                # every quantized run documents its measured approximation
                # error (the W8A8 reranker guard)
                with open(os.path.join(
                    self.experiment_folder,
                    f"eval_{dataset_split}_rerank_fidelity.json",
                ), "w") as f:
                    json.dump(rr_fid, f, indent=2)
        else:
            query_ids, doc_ids, scores = _mesh.broadcast_object(
                utils.load_trec(reranking_file) if lead else None)
        if not lead:
            return query_ids, doc_ids, scores
        shutil.copyfile(
            reranking_file,
            os.path.join(self.experiment_folder, os.path.basename(reranking_file)),
        )
        if "ranking_label" in self.datasets[dataset_split]["query"].features:
            doc_ds = dataset["doc"]
            wiki_ids = (
                [utils.get_by_id(doc_ds, d, "wikipedia_id") for d in doc_ids]
                if "wikipedia_id" in doc_ds.features
                else doc_ids
            )
            utils.eval_retrieval_kilt(
                self.experiment_folder, self.qrels_folder, query_dataset_name,
                doc_dataset_name, dataset_split, query_ids, wiki_ids, scores,
                top_k=self.generation_top_k, reranking=True, debug=self.debug,
            )
        return query_ids, doc_ids, scores

    def process_context(self, gen_dataset, query_dataset_name,
                        doc_dataset_name, dataset_split):
        fname = utils.get_context_processing_filename(
            self.processed_context_folder, query_dataset_name, doc_dataset_name,
            dataset_split, self.retriever.get_clean_model_name(),
            self.retrieve_top_k,
            self.reranker.get_clean_model_name() if self.reranker else None,
            self.rerank_top_k, self.generation_top_k,
            self.query_generator.get_clean_model_name(),
            self.context_processor.get_clean_model_name(),
        )
        lead = self.rank == 0
        # rank 0 decides, for every rank, whether the saved file serves
        if _mesh.broadcast_object(lead and (
                not os.path.exists(fname) or self.overwrite_exp
                or self.overwrite_index)):
            contexts = [list(d) for d in gen_dataset["doc"]]
            queries = list(gen_dataset["query"])
            processed, context_metrics = self.context_processor.eval(
                contexts, queries
            )
            if lead:
                os.makedirs(self.processed_context_folder, exist_ok=True)
                with open(fname, "w") as fp:
                    json.dump(
                        {
                            "processed_contexts": processed,
                            "context_metrics": context_metrics,
                            "original_contexts": contexts,
                            "queries": queries,
                        },
                        fp,
                    )
        else:
            saved = None
            if lead:
                with open(fname) as fp:
                    saved = json.load(fp)
            saved = _mesh.broadcast_object(saved)
            processed = saved["processed_contexts"]
            context_metrics = saved["context_metrics"]
        gen_dataset = gen_dataset.remove_columns("doc")
        gen_dataset = gen_dataset.add_column("doc", processed)
        if lead:
            shutil.copyfile(fname, os.path.join(self.experiment_folder,
                                                os.path.basename(fname)))
            utils.write_dict(
                self.experiment_folder,
                f"eval_{dataset_split}_context_metrics.json",
                context_metrics,
            )
        return gen_dataset

    def generate(self, gen_dataset, dataset_split):
        t0 = time.time()
        (query_ids, questions, instructions, predictions, references,
         ranking_labels) = self.generator.eval(gen_dataset)
        generation_time = time.time() - t0
        utils.write_generated(
            self.experiment_folder, f"eval_{dataset_split}_out.json",
            query_ids, questions, instructions, predictions, references,
            ranking_labels,
        )
        if hasattr(self.generator, "total_cost"):
            utils.write_dict(
                self.experiment_folder,
                f"eval_{dataset_split}_generation_cost.json",
                {
                    "total_cost": self.generator.total_cost,
                    "prompt_cost": self.generator.prompt_cost,
                    "completion_cost": self.generator.completion_cost,
                },
            )
        utils.write_dict(
            self.experiment_folder,
            f"eval_{dataset_split}_generation_time.json",
            utils.format_time("Generation time", generation_time),
        )
        return questions, instructions, predictions, references

    def train(self):
        """Generator SFT over retrieved contexts (JAX ``rag.py:415-483``):
        the staged retrieval of eval (no ranking eval), rerank and context
        processing where configured, JAX's train/test split with seed 42,
        the trainer (LoRA or full), ``train_history.json``, then the move of
        the finished experiment.  The merged generator stays on
        ``self.generator``.  Under ``torchrun`` every rank joins every
        stage and trains its slice of a tensor-parallel generator (each
        model row the same batches); rank 0 writes."""
        dataset_split = "train"
        dataset = self.datasets[dataset_split]
        query_dataset_name = dataset["query"].name
        doc_dataset_name = dataset["doc"].name if dataset.get("doc") else None

        if self.retriever is not None:
            dataset = self.generate_query(dataset, query_dataset_name,
                                          dataset_split)
            query_ids, doc_ids, _ = self.retrieve(
                dataset, query_dataset_name, doc_dataset_name, dataset_split,
                self.retrieve_top_k, eval_ranking=False,
            )
        else:
            query_ids, doc_ids = None, None
        if self.reranker is not None and doc_ids is not None:
            query_ids, doc_ids, _ = self.rerank(
                dataset, query_dataset_name, doc_dataset_name, dataset_split,
                query_ids, doc_ids, self.rerank_top_k,
            )
        if doc_ids is not None:
            doc_ids = [d[: self.generation_top_k] for d in doc_ids]
        gen_dataset = utils.prepare_dataset_from_ids(
            dataset, query_ids, doc_ids, multi_doc=True
        )
        if self.context_processor is not None and self.retriever is not None:
            gen_dataset = self.process_context(
                gen_dataset, query_dataset_name, doc_dataset_name, dataset_split
            )

        test_size = self.training_config.get("test_size", 64)
        if isinstance(test_size, int):
            test_size = min(len(gen_dataset) // 2, test_size)
        split = utils.train_test_split(gen_dataset, test_size, seed=42)

        def format_rows(rows):
            out = []
            for item in rows:
                prompt, label_start = self.generator.format_instruction(
                    item, eval=False
                )
                out.append({"formatted_instruction": prompt,
                            "label_start_index": label_start})
            return out

        from bergen_tpu_torch.train.trainer import SFTTrainer

        trainer = SFTTrainer(
            self.generator,
            format_rows(split["train"]),
            format_rows(split["test"]),
            self.training_config,
            output_dir=os.path.join(self.experiment_folder, "train"),
        )
        pre_loss = trainer.evaluate()
        result = trainer.train()
        result["pre_train_eval_loss"] = pre_loss
        lead = self.rank == 0
        if lead:
            utils.write_dict(self.experiment_folder, "train_history.json",
                             result)
        self.experiment_folder = _mesh.broadcast_object(
            utils.move_finished_experiment(self.experiment_folder) if lead
            else None)
        return result

    def eval_metrics(self, dataset_split, questions, predictions, references):
        if predictions is None and references is None and questions is None:
            return
        metric_cls = self.metrics[dataset_split]
        if metric_cls is None:
            return
        out_file = os.path.join(
            self.experiment_folder, f"eval_{dataset_split}_out.json"
        )
        with open(out_file) as fd:
            generated = json.load(fd)
        metrics_out = metric_cls.compute(
            predictions=predictions, references=references, questions=questions
        )
        for row_i, row in enumerate(generated):
            for m in metrics_out:
                row[m] = metrics_out[m][row_i]
        avg = {m: float(np.mean(v)) for m, v in metrics_out.items()}
        utils.write_dict(
            self.experiment_folder, f"eval_{dataset_split}_metrics.json", avg
        )
        with open(out_file, "w") as fd:
            json.dump(generated, fd, indent=2)
