"""Language-ID evaluation (the PyTorch port's copy of
``bergen_tpu/models/evaluators/lid.py``; reference
``models/evaluators/lid.py``): fraction of generated answers in the expected
target language.

The reference shells into fasttext's ``lid.176.bin``, which cannot be
fetched here; the port runs the JAX package's dependency-free detector
alone: Unicode-script ranges for non-Latin languages plus stopword profiles
for Latin-script languages.  (The JAX package prefers fasttext when it is
importable and a model file is present; the port imports neither.)
"""

from __future__ import annotations

import re
from collections import Counter

from bergen_tpu_torch.models.evaluators.utils import get_mean_without_unknown

_SCRIPTS = [
    ("zh", re.compile(r"[一-鿿]")),
    ("ja", re.compile(r"[぀-ヿ]")),
    ("ko", re.compile(r"[가-힯]")),
    ("ar", re.compile(r"[؀-ۿ]")),
    ("ru", re.compile(r"[Ѐ-ӿ]")),
    ("th", re.compile(r"[฀-๿]")),
    ("he", re.compile(r"[֐-׿]")),
    ("km", re.compile(r"[ក-៿]")),
]

_STOPWORDS = {
    "en": {"the", "is", "of", "and", "to", "in", "a", "was", "it", "that"},
    "fr": {"le", "la", "les", "de", "des", "et", "est", "une", "un", "dans"},
    "de": {"der", "die", "das", "und", "ist", "von", "ein", "eine", "nicht", "mit"},
    "es": {"el", "la", "los", "las", "de", "y", "es", "una", "en", "que"},
    "it": {"il", "la", "di", "e", "è", "una", "che", "per", "non", "sono"},
    "pt": {"o", "a", "os", "as", "de", "e", "é", "uma", "em", "que"},
    "nl": {"de", "het", "een", "en", "is", "van", "niet", "dat", "op", "te"},
    "da": {"og", "er", "det", "en", "af", "til", "på", "med", "den", "ikke"},
    "sv": {"och", "är", "det", "en", "av", "till", "på", "med", "den", "inte"},
    "no": {"og", "er", "det", "en", "av", "til", "på", "med", "den", "ikke"},
    "fi": {"on", "ja", "se", "ei", "että", "oli", "joka", "mutta", "hän", "myös"},
    "pl": {"i", "w", "nie", "to", "jest", "na", "się", "z", "że", "do"},
    "tr": {"bir", "ve", "bu", "için", "ile", "da", "de", "olarak", "en", "değil"},
    "vi": {"là", "của", "và", "các", "có", "được", "trong", "một", "không", "người"},
    "hu": {"a", "az", "és", "hogy", "nem", "is", "egy", "van", "volt", "meg"},
    "ms": {"dan", "yang", "di", "ini", "untuk", "dengan", "adalah", "pada", "tidak", "itu"},
}


def detect_language(text: str) -> str:
    """Best-effort language code for text ('un' if undecidable)."""
    if not text or not text.strip():
        return "un"
    counts = Counter()
    for lang, pat in _SCRIPTS:
        counts[lang] = len(pat.findall(text))
    best_script, best_n = counts.most_common(1)[0] if counts else ("un", 0)
    n_alpha = sum(1 for c in text if c.isalpha())
    if best_n > 0 and n_alpha > 0 and best_n / n_alpha > 0.3:
        return best_script
    words = set(re.findall(r"[\w']+", text.lower()))
    scores = {
        lang: len(words & sw) for lang, sw in _STOPWORDS.items()
    }
    best = max(scores, key=scores.get)
    return best if scores[best] > 0 else "un"


class LID:
    """Correct-language rate of predictions vs the dataset's target language."""

    def __init__(self, tgt_lng: str = "en"):
        self.tgt_lng = tgt_lng

    def _detect(self, text: str) -> str:
        return detect_language(text)

    def __call__(self, predictions, references, questions=None):
        scores = [
            float(self._detect(p) == self.tgt_lng) for p in predictions
        ]
        return get_mean_without_unknown(scores), scores


class LID_advanced(LID):
    """Gold-language fallback variant (reference lid_advanced.py): a prediction
    also counts as correct-language if it matches the gold label text (names
    etc. are language-neutral)."""

    def __call__(self, predictions, references, questions=None):
        scores = []
        for p, refs in zip(predictions, references):
            refs = refs if isinstance(refs, list) else [refs]
            ok = self._detect(p) == self.tgt_lng or any(
                r.strip().lower() == p.strip().lower() for r in refs
            )
            scores.append(float(ok))
        return get_mean_without_unknown(scores), scores
