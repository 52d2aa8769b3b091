"""Shared evaluator scoring helpers (the PyTorch port's copy of
``bergen_tpu/models/evaluators/utils.py``; reference
``models/evaluators/utils.py``)."""

from __future__ import annotations

import numpy as np

UNKNOWN = -100


def process_llm_outputs_assess_scores(outputs, options, unknown_value=UNKNOWN):
    """Map judge text → option value by substring match; ambiguous/absent →
    unknown. Returns (scores, weird_outputs)."""
    possible = [[options[o] for o in options if o in rep] for rep in outputs]
    scores = [p[0] if len(p) == 1 else unknown_value for p in possible]
    weird = [rep for i, rep in enumerate(outputs) if len(possible[i]) != 1]
    return scores, weird


def get_mean_without_unknown(scores, unknown_value=UNKNOWN):
    ok = [s for s in scores if s != unknown_value]
    return float(np.mean(ok)) if ok else 0


def unswitch_switched_scores(switched_scores, switches):
    """Undo the random answer-order switch used to deter positional bias in
    pairwise judging."""
    assert len(switched_scores) == len(switches)
    out = []
    for s, sw in zip(switched_scores, switches):
        if not (0.0 <= s <= 1.0):
            out.append(s)
        else:
            out.append(1 - s if sw else s)
    return out


def get_pairwise_scores_without_unknown(scores, unknown_value=UNKNOWN) -> dict:
    valid = [s for s in scores if 0.0 <= s <= 1.0]
    n = max(1e-6, len(valid))
    return {
        "win": valid.count(1) * 100.0 / n,
        "tie": valid.count(0.5) * 100.0 / n,
        "lose": valid.count(0) * 100.0 / n,
    }
