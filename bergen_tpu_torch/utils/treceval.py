"""Minimal trec_eval-compatible metrics (pytrec_eval replacement).

The reference evaluates rankings with ``pytrec_eval.RelevanceEvaluator`` over the
measures ``P_1`` and ``recall_k`` only (reference ``utils.py:275``). This module
reimplements exactly those trec_eval semantics in pure Python:

* documents are ranked by descending score; ties broken by **reverse
  lexicographic docid** (trec_eval's historical tie-break).
* ``P_k``   = (# relevant in top-k) / k
* ``recall_k`` = (# relevant in top-k) / (# relevant in qrel)
* queries present in the run but absent from the qrel are skipped (trec_eval
  evaluates the intersection); relevance > 0 counts as relevant.
"""

from __future__ import annotations

from typing import Mapping, Sequence

__all__ = ["evaluate"]


def _parse_measure(measure: str) -> tuple[str, int]:
    base, _, cut = measure.partition("_")
    return base, int(cut)


def _ranked_docids(doc_scores: Mapping[str, float]) -> list[str]:
    # trec_eval sorts by score DESC, tie-break docid DESC
    return [
        d
        for d, _ in sorted(
            doc_scores.items(), key=lambda kv: (kv[1], kv[0]), reverse=True
        )
    ]


def evaluate(
    qrel: Mapping[str, Mapping[str, int]],
    run: Mapping[str, Mapping[str, float]],
    measures: Sequence[str],
) -> dict[str, dict[str, float]]:
    parsed = [(m, *_parse_measure(m)) for m in measures]
    out: dict[str, dict[str, float]] = {}
    for q_id, doc_scores in run.items():
        if q_id not in qrel:
            continue
        relevant = {d for d, r in qrel[q_id].items() if int(r) > 0}
        ranked = _ranked_docids(doc_scores)
        scores: dict[str, float] = {}
        for name, base, k in parsed:
            hits = sum(1 for d in ranked[:k] if d in relevant)
            if base == "P":
                scores[name] = hits / k
            elif base == "recall":
                scores[name] = hits / len(relevant) if relevant else 0.0
            else:
                raise ValueError(f"Unsupported measure '{name}'")
        out[q_id] = scores
    return out
