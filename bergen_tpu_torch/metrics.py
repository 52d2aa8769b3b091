"""Lexical RAG metrics.

Semantics mirror reference ``modules/metrics.py:32-145`` exactly (normalization,
token F1/P/R with max over multiple gold labels, char-3gram recall as the
multilingual headline metric, ROUGE-1/2/L, EM, and the substring "Match" metric)
so that scores computed over the same ``eval_*_out.json`` are identical.
Pure Python / CPU — deliberately not device code.
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Callable, List

try:
    from rouge import Rouge

    _rouge = Rouge()
except Exception:  # pragma: no cover - rouge is expected in the image
    _rouge = None

_ARTICLES_RE = re.compile(r"\b(a|an|the)\b")
_PUNC = set(string.punctuation)


def normalize(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in _PUNC)
    s = _ARTICLES_RE.sub(" ", s)
    return " ".join(s.split())


def char_ngrams(s: str, n: int = 3) -> List[str]:
    """Whitespace-split after punctuation→space, then all char n-grams per word
    (words shorter than n kept whole) — reference metrics.py:60-71."""
    s = "".join(ch if ch not in _PUNC else " " for ch in s.lower())
    tokens: List[str] = []
    for w in s.split():
        if len(w) < n:
            tokens.append(w)
        else:
            tokens.extend(w[i : i + n] for i in range(len(w) - n + 1))
    return tokens


def f1_single(prediction: str, ground_truth: str,
              tokenfun: Callable[[str], List[str]] = lambda x: x.split()):
    pred_tokens = tokenfun(normalize(prediction))
    gt_tokens = tokenfun(normalize(ground_truth))
    common = Counter(pred_tokens) & Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0, 0.0, 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return (2 * precision * recall) / (precision + recall), precision, recall


def f1_score(predictions, references,
             tokenfun: Callable[[str], List[str]] = lambda x: x.split()):
    f1s, ps, rs = [], [], []
    for gts, pred in zip(references, predictions):
        per_gt = [f1_single(pred, gt, tokenfun) for gt in gts]
        best = [max(vals) for vals in zip(*per_gt)]
        f1s.append(best[0])
        ps.append(best[1])
        rs.append(best[2])
    return {"f1": f1s, "precision": ps, "recall": rs}


def em_single(prediction: str, ground_truth: str) -> float:
    return float(normalize(prediction) == normalize(ground_truth))


def exact_match_score(predictions, references):
    return [
        max(em_single(pred, gt) for gt in gts)
        for gts, pred in zip(references, predictions)
    ]


def match_single(prediction: str, ground_truth: str) -> float:
    """'Match' = normalized gold label is a substring of the normalized
    prediction (reference metrics.py:119-126) — the paper's headline metric."""
    return float(normalize(ground_truth) in normalize(prediction))


def match_score(predictions, references):
    assert isinstance(references[0], list), (
        f"Labels are type {type(references[0])}, expected list of strings per "
        "sample (even if only one label)."
    )
    return [
        max(match_single(pred, gt) for gt in gts)
        for gts, pred in zip(references, predictions)
    ]


def _rouge_wrapper(prediction: str, ground_truth: str):
    if _rouge is None:
        return 0.0, 0.0, 0.0
    try:
        r = _rouge.get_scores(prediction, ground_truth, avg=True)
        return r["rouge-1"]["f"], r["rouge-2"]["f"], r["rouge-l"]["f"]
    except Exception:
        return 0.0, 0.0, 0.0


def rouge_score_single(prediction: str, ground_truths):
    ground_truths = [g for g in ground_truths if len(g) > 0]
    if len(prediction) == 0 or len(ground_truths) == 0:
        return 0.0, 0.0, 0.0
    scores = [_rouge_wrapper(prediction, gt) for gt in ground_truths]
    return tuple(max(s[i] for s in scores) for i in range(3))


def rouge_score(predictions, references):
    r1, r2, rl = [], [], []
    for gts, pred in zip(references, predictions):
        a, b, c = rouge_score_single(pred, gts)
        r1.append(a)
        r2.append(b)
        rl.append(c)
    return {"rouge1": r1, "rouge2": r2, "rougel": rl}


class RAGMetrics:
    """Per-sample metric lists, averaged later into eval_{split}_metrics.json
    (reference metrics.py:130-145)."""

    @staticmethod
    def compute(predictions, references, questions=None):
        rouge_ = rouge_score(predictions, references)
        f1s = f1_score(predictions, references)
        recall_3gram = f1_score(predictions, references, char_ngrams)["recall"]
        return {
            "M": match_score(predictions, references),
            "EM": exact_match_score(predictions, references),
            "F1": f1s["f1"],
            "Precision": f1s["precision"],
            "Recall": f1s["recall"],
            "Recall_char3gram": recall_3gram,
            "Rouge-1": rouge_["rouge1"],
            "Rouge-2": rouge_["rouge2"],
            "Rouge-L": rouge_["rougel"],
        }
