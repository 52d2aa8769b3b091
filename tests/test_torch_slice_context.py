"""Context processing and query rewriting through the whole pipeline: the
rag_ut1 eval (tiny BERT retriever, tiny llama generator) through
``bergen.main`` and through ``python -m bergen_tpu_torch ... device=cpu``,
in separate folders, with

1. ``context_processor`` recomp/recomp_ext_top1 (its config's keys as
   ``+context_processor.init_args.*`` overrides; the tiny BERT as the
   sentence encoder);
2. ``query_generator`` translate/de (a tiny M2M100 with an NLLB-layout
   tokenizer) and ``context_processor`` dslr/dslr_ce_bge_t05 (a tiny BERT
   cross-encoder).

Each gives the same processed-context JSON (and generated-queries JSON),
context metrics, byte-identical ``eval_dev_out.json`` and equal metrics.
"""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_slice import REPO, _overrides, _run_both  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module's tests (and OMP_NUM_THREADS=1 in
    the CLI subprocesses): the suite runs several workers on the host's
    cores, and torch's default of a thread a core oversubscribes them."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config_overrides(group: str, option: str, **replace) -> list[str]:
    """``config/<group>/<option>.yaml``'s init_args as ``+group.init_args``
    overrides (the root configs have no such group), with ``replace``'s
    values in place of the file's."""
    from bergen_tpu import confy

    args = dict(confy.load_yaml(os.path.join(
        REPO, "config", group, f"{option}.yaml"))["init_args"], **replace)
    return [f"+{group}.init_args.{k}={json.dumps(v)}" for k, v in args.items()]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from test_torch_query_generators import build_tiny_nllb
    from tiny_models import build_tiny_bert, build_tiny_llama

    root = tmp_path_factory.mktemp("models")
    return {"bert": build_tiny_bert(str(root / "bert")),
            "ce": build_tiny_bert(str(root / "ce"), num_labels=1, seed=5),
            "llama": build_tiny_llama(str(root / "llama")),
            "nllb": build_tiny_nllb(str(root / "nllb"))}


def _assert_same_files(jexp, texp, prefix):
    names = [n for n in os.listdir(jexp) if n.startswith(prefix)]
    assert len(names) == 1, names
    with open(os.path.join(jexp, names[0])) as f, \
            open(os.path.join(texp, names[0])) as g:
        ref, out = json.load(f), json.load(g)
    assert out == ref
    return out


def _assert_same_eval(jexp, texp):
    with open(os.path.join(jexp, "eval_dev_out.json"), "rb") as f, \
            open(os.path.join(texp, "eval_dev_out.json"), "rb") as g:
        assert f.read() == g.read()
    for name in ("eval_dev_metrics.json", "eval_dev_ranking_metrics.json",
                 "eval_dev_context_metrics.json"):
        with open(os.path.join(jexp, name)) as f, \
                open(os.path.join(texp, name)) as g:
            assert json.load(f) == json.load(g), name
    with open(os.path.join(texp, "eval_dev_stage_times.json")) as f:
        assert "process_context" in json.load(f)


def test_recomp_extractive_stage_matches_jax(tmp_path, models):
    def overrides(root):
        return _overrides(root, models) + config_overrides(
            "context_processor", "recomp/recomp_ext_top1",
            model_name=models["bert"], max_len=64, batch_size=16)

    jexp, texp = _run_both(tmp_path, overrides)
    saved = _assert_same_files(jexp, texp,
                               "processed_contexts.recomp_Ext_top1.")
    # ut1's docs are a title sentence and one more: top-1 keeps both
    assert len(saved["processed_contexts"]) == 50
    assert [len(r) for r in saved["processed_contexts"]] == [5] * 50
    _assert_same_eval(jexp, texp)
    # the port's own folder also caches the JSON under the shared name
    cached = os.listdir(tmp_path / "torch" / "processed_contexts")
    assert [n for n in os.listdir(texp) if n.startswith("processed_")] \
        == cached


def test_translate_query_and_dslr_stage_match_jax(tmp_path, models):
    def overrides(root):
        return _overrides(root, models) + config_overrides(
            "query_generator", "translate/de", model_name=models["nllb"],
            max_new_tokens=4, batch_size=25) + config_overrides(
            "context_processor", "dslr/dslr_ce_bge_t05",
            model_name=models["ce"], max_len=64)

    jexp, texp = _run_both(tmp_path, overrides)
    queries = _assert_same_files(jexp, texp, "generated_queries.")
    assert len(queries["generated_queries"]) == 50
    saved = _assert_same_files(
        jexp, texp, "processed_contexts.dslrce_Ext_t0.5.")
    assert saved["queries"][0] != ""
    _assert_same_eval(jexp, texp)
    runs = [n for n in os.listdir(texp) if n.startswith("run.retrieve.")]
    assert len(runs) == 1 and runs[0].endswith(
        ".translate_deu_Latn_eng_Latn.trec")
