"""Provence training on the port (``bergen_tpu_torch/train/provence.py``)
against the JAX package's (``bergen_tpu/train/provence.py``) on a tiny
DeBERTa cross-encoder, f32 on the CPU, from the same carried-across heads
(``convert.load_flat``: JAX draws its new heads with ``jax.random``):

* the teacher's ranking head kept, the collation equal to JAX's;
* the joint loss and four training steps on the same batches within 1e-5
  relative, and the eval metrics after them within 1e-5;
* ``python -m bergen_tpu_torch.train.provence`` (the root script's flags,
  ``--device cpu``) writing ``train_log.csv`` and ``provence_params.npz``
  with JAX's parameter names and shapes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch thread for this module's tests: the suite runs several
    workers on the host's cores, and torch's default of a thread a core
    then oversubscribes them (tens of times slower at these tiny shapes)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5


def _rows(n):
    rng = np.random.default_rng(0)
    return [{"query": "which sentence matters",
             "context": ["gold answer sentence here", "irrelevant filler text",
                         "more filler words"],
             "selected_sents": [0], "ranking_label": float(rng.normal())}
            for _ in range(n)]


@pytest.fixture(scope="module")
def deberta_dir(tmp_path_factory):
    from tiny_models import build_tiny_bert
    from transformers import (AutoTokenizer, DebertaV2Config,
                              DebertaV2ForSequenceClassification)

    out = str(tmp_path_factory.mktemp("deberta"))
    build_tiny_bert(out)  # the WordPiece tokenizer with [CLS]/[SEP]
    tok = AutoTokenizer.from_pretrained(out)
    torch.manual_seed(0)
    cfg = DebertaV2Config(
        vocab_size=tok.vocab_size, hidden_size=48, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=96,
        max_position_embeddings=64, type_vocab_size=0, position_buckets=16,
        max_relative_positions=-1, norm_rel_ebd="layer_norm",
        relative_attention=True, pos_att_type=["p2c", "c2p"],
        position_biased_input=False, share_att_key=True, num_labels=1)
    DebertaV2ForSequenceClassification(cfg).save_pretrained(
        out, safe_serialization=True)
    return out


@pytest.fixture(scope="module")
def trainers(deberta_dir, tmp_path_factory):
    from bergen_tpu.train.provence import ProvenceTrainer as JTrainer
    from bergen_tpu_torch.models import convert
    from bergen_tpu_torch.train.provence import ProvenceTrainer

    out = tmp_path_factory.mktemp("provence")
    kw = dict(max_len=48, batch_size=8, epochs=2, lr=5e-4)
    j = JTrainer(deberta_dir, _rows(32), _rows(8), str(out / "j"), **kw)
    t = ProvenceTrainer(deberta_dir, _rows(32), _rows(8), str(out / "t"),
                        device="cpu", **kw)
    convert.load_flat(t.params, convert.flatten_paths(j.params))
    return j, t


def test_teacher_ranking_head_is_reused(deberta_dir, trainers):
    from transformers import DebertaV2ForSequenceClassification

    hf = DebertaV2ForSequenceClassification.from_pretrained(deberta_dir)
    from bergen_tpu_torch.models import convert
    from bergen_tpu_torch.train.provence import ProvenceTrainer

    t = ProvenceTrainer(deberta_dir, _rows(2), _rows(2),
                        str(trainers[1].output_dir) + "_fresh", max_len=48,
                        batch_size=2, device="cpu")
    np.testing.assert_allclose(t.params["classifier"]["kernel"].numpy(),
                               hf.classifier.weight.detach().numpy().T,
                               atol=1e-6)
    np.testing.assert_allclose(t.params["pooler"]["kernel"].numpy(),
                               hf.pooler.dense.weight.detach().numpy().T,
                               atol=1e-6)
    assert t.params["token_classifier"]["kernel"].shape == (48, 2)
    assert set(convert.flatten_paths(t.params)) == set(
        convert.flatten_paths(trainers[0].params))


def test_collation_matches_jax(trainers):
    j, t = trainers
    jb, tb = j._collate(_rows(3)), t._collate(_rows(3))
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_joint_loss_and_steps_match_jax(trainers):
    j, t = trainers
    jb = list(j._batches(j.train_rows, True))
    tb = list(t.batches(t.train_rows, True))
    assert len(jb) == len(tb) == 4
    for i in range(4):
        j.params, j.opt_state, loss, comp, rank = j._train_step(
            j.params, j.opt_state, jb[i])
        tl, tc, tr = t.train_step(tb[i])
        assert tl == pytest.approx(float(loss), rel=REL), i
        assert tc == pytest.approx(float(comp), rel=REL)
        assert tr == pytest.approx(float(rank), rel=REL)
    je, te = j.evaluate(), t.evaluate()
    assert set(te) == set(je)
    for k in je:
        assert te[k] == pytest.approx(je[k], rel=REL, abs=1e-7), k


def test_provence_cli_writes_jax_outputs(deberta_dir, trainers, tmp_path):
    from bergen_tpu_torch.models import convert

    silver = tmp_path / "silver"
    silver.mkdir()
    for i, row in enumerate(_rows(12)):
        with open(silver / f"q{i}_d{i}.json", "w") as f:
            json.dump({"query": row["query"], "context": row["context"],
                       "selected_sents": row["selected_sents"],
                       "response": "[0]"}, f)
    trec = tmp_path / "teacher.trec"
    with open(trec, "w") as f:
        for i in range(12):
            f.write(f"q{i}\tq0\td{i}\t1\t{1.5 + i * 0.1}\trun\n")
    out = subprocess.run(
        [sys.executable, "-m", "bergen_tpu_torch.train.provence",
         "--silver_dir", str(silver), "--teacher_trec", str(trec),
         "--model", deberta_dir, "--outdir", str(tmp_path / "run"),
         "--max_len", "48", "--batch_size", "4", "--epochs", "1",
         "--eval_fraction", "0.25", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tail = json.loads(out.stdout.strip().splitlines()[-1])
    assert tail["steps"] == 2 and set(tail["eval"]) == {
        "loss", "acc", "precision", "recall", "f1"}
    with open(tmp_path / "run" / "train_log.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == "step,loss,compression_loss,ranking_loss"
    assert len(lines) == 3
    saved = np.load(tmp_path / "run" / "provence_params.npz")
    ref = convert.flatten_paths(trainers[0].params)
    assert set(saved.files) == set(ref)
    assert all(saved[k].shape == np.asarray(ref[k]).shape for k in ref)
