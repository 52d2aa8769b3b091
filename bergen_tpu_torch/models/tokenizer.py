"""A reader for HF ``tokenizer.json`` / ``tokenizer_config.json`` files.

The port's machine has neither ``transformers`` nor ``tokenizers``, so the
port carries the part of them its checkpoints use, with the same results as
``AutoTokenizer`` on those files:

* models: WordPiece and WordLevel;
* normalizers: Lowercase, StripAccents (and a Sequence of them);
* pre-tokenizers: Whitespace, WhitespaceSplit, Punctuation (Removed or
  Isolated), and a Sequence of them;
* the TemplateProcessing post-processor (``[CLS] $A [SEP]``), with
  truncation that leaves room for its special tokens;
* added tokens, matched in the raw text before normalisation;
* ``decode``/``batch_decode`` (no decoder: tokens joined by spaces, or the
  WordPiece decoder), ``skip_special_tokens``;
* ``apply_chat_template`` rendered with jinja2 as transformers renders it.

Any other component raises ``NotImplementedError`` naming it.
``write_tokenizer`` writes such files (used to make checkpoints without
``tokenizers``).
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Iterable

_WHITESPACE_RE = re.compile(r"\w+|[^\w\s]+")


def _is_punc(c: str) -> bool:
    return (c.isascii() and not c.isalnum() and c.isprintable()
            and not c.isspace()) or unicodedata.category(c).startswith("P")


def _normalizer(spec):
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]

        def seq(s):
            for f in steps:
                s = f(s)
            return s

        return seq
    if kind == "Lowercase":
        return str.lower
    if kind == "StripAccents":
        return lambda s: "".join(c for c in s
                                 if unicodedata.category(c) != "Mn")
    raise NotImplementedError(f"tokenizer normalizer {kind!r}")


def _pre_tokenizer(spec):
    """-> function: list of pieces -> list of pieces."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces):
            for f in steps:
                pieces = f(pieces)
            return pieces

        return seq
    if kind == "Whitespace":
        return lambda pieces: [m for p in pieces
                               for m in _WHITESPACE_RE.findall(p)]
    if kind == "WhitespaceSplit":
        return lambda pieces: [m for p in pieces for m in p.split()]
    if kind == "Punctuation":
        behavior = spec.get("behavior", "Isolated")
        if behavior not in ("Removed", "Isolated"):
            raise NotImplementedError(
                f"tokenizer Punctuation behavior {behavior!r}")
        keep = behavior == "Isolated"

        def punct(pieces):
            out = []
            for p in pieces:
                cur = ""
                for c in p:
                    if _is_punc(c):
                        if cur:
                            out.append(cur)
                            cur = ""
                        if keep:
                            out.append(c)
                    else:
                        cur += c
                if cur:
                    out.append(cur)
            return out

        return punct
    raise NotImplementedError(f"tokenizer pre-tokenizer {kind!r}")


class _WordPiece:
    def __init__(self, spec):
        self.vocab = spec["vocab"]
        self.unk = spec["unk_token"]
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)

    def tokenize(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return [self.vocab[self.unk]]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = self.prefix + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.vocab[self.unk]]
            out.append(cur)
            start = end
        return out


class _WordLevel:
    def __init__(self, spec):
        self.vocab = spec["vocab"]
        self.unk = spec["unk_token"]

    def tokenize(self, word: str) -> list[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        return [self.vocab[self.unk]]


def _token_str(v):
    return v.get("content") if isinstance(v, dict) else v


class Tokenizer:
    """The subset of a transformers fast tokenizer the pipeline calls."""

    SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                    "pad_token", "cls_token", "mask_token")

    def __init__(self, spec: dict, config: dict | None = None,
                 chat_template: str | None = None):
        config = config or {}
        model = spec["model"]
        if model["type"] == "WordPiece":
            self.model = _WordPiece(model)
        elif model["type"] == "WordLevel":
            self.model = _WordLevel(model)
        else:
            raise NotImplementedError(f"tokenizer model {model['type']!r}")
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        post = spec.get("post_processor")
        if post is not None and post["type"] != "TemplateProcessing":
            raise NotImplementedError(
                f"tokenizer post-processor {post['type']!r}")
        self.template = post
        dec = spec.get("decoder")
        if dec is not None and dec["type"] != "WordPiece":
            raise NotImplementedError(f"tokenizer decoder {dec['type']!r}")
        self.decoder = dec
        self.added = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        self.special_ids = {t["id"] for t in spec.get("added_tokens", [])
                            if t.get("special")}
        self.id_to_token = {i: t for t, i in self.model.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self._added_re = (re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added else None)
        self.clean_up_spaces = bool(config.get("clean_up_tokenization_spaces",
                                               False))
        self.special_tokens = {k: _token_str(config[k])
                               for k in self.SPECIAL_KEYS
                               if config.get(k) is not None}
        self.chat_template = chat_template if chat_template is not None \
            else config.get("chat_template")

    @classmethod
    def from_pretrained(cls, path: str) -> "Tokenizer":
        with open(os.path.join(path, "tokenizer.json")) as f:
            spec = json.load(f)
        config = {}
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                config = json.load(f)
        template = None
        jinja_path = os.path.join(path, "chat_template.jinja")
        if os.path.exists(jinja_path):
            with open(jinja_path) as f:
                template = f.read()
        return cls(spec, config, template)

    # ----- special tokens --------------------------------------------------

    def token_to_id(self, token: str | None) -> int | None:
        if token is None:
            return None
        if token in self.added:
            return self.added[token]
        return self.model.vocab.get(token)

    def __getattr__(self, name):
        if name == "special_tokens":
            raise AttributeError(name)
        if name.endswith("_token_id") and name[:-3] in self.SPECIAL_KEYS:
            return self.token_to_id(self.special_tokens.get(name[:-3]))
        if name in self.SPECIAL_KEYS:
            return self.special_tokens.get(name)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self.SPECIAL_KEYS:
            self.special_tokens[name] = value
        else:
            super().__setattr__(name, value)

    # ----- encode ----------------------------------------------------------

    def _encode_raw(self, text: str) -> list[int]:
        ids: list[int] = []
        segments = []
        pos = 0
        if self._added_re is not None:
            for m in self._added_re.finditer(text):
                segments.append((text[pos:m.start()], None))
                segments.append((m.group(0), self.added[m.group(0)]))
                pos = m.end()
        segments.append((text[pos:], None))
        for seg, added_id in segments:
            if added_id is not None:
                ids.append(added_id)
                continue
            if not seg:
                continue
            for word in self.pre_tokenize([self.normalize(seg)]):
                ids.extend(self.model.tokenize(word))
        return ids

    def _template_ids(self) -> tuple[list[int], list[int]]:
        """(ids before $A, ids after $A) of the single-sequence template."""
        before, after, seen = [], [], False
        for piece in self.template["single"]:
            if "Sequence" in piece:
                seen = True
                continue
            name = piece["SpecialToken"]["id"]
            ids = self.template["special_tokens"][name]["ids"]
            (after if seen else before).extend(ids)
        return before, after

    def encode(self, text: str, add_special_tokens: bool = True,
               truncation: bool = False,
               max_length: int | None = None) -> list[int]:
        ids = self._encode_raw(text)
        before, after = ([], [])
        if add_special_tokens and self.template is not None:
            before, after = self._template_ids()
        if truncation and max_length is not None:
            ids = ids[:max(0, max_length - len(before) - len(after))]
        return before + ids + after

    def __call__(self, texts, truncation: bool = False,
                 max_length: int | None = None,
                 add_special_tokens: bool = True):
        """{"input_ids": ids} for one text, or a list of them (unpadded:
        callers pad)."""
        if isinstance(texts, str):
            return {"input_ids": self.encode(texts, add_special_tokens,
                                             truncation, max_length)}
        return {"input_ids": [self.encode(t, add_special_tokens, truncation,
                                          max_length) for t in texts]}

    # ----- decode ----------------------------------------------------------

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False):
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                continue
            tok = self.id_to_token.get(i)
            if tok is not None:
                toks.append(tok)
        if self.decoder is None:
            text = " ".join(toks)
        else:
            prefix = self.decoder.get("prefix", "##")
            parts = []
            for n, tok in enumerate(toks):
                if tok.startswith(prefix):
                    parts.append(tok[len(prefix):])
                elif n > 0:
                    parts.append(" " + tok)
                else:
                    parts.append(tok)
            text = "".join(parts)
            if self.decoder.get("cleanup", True):
                text = _clean_up(text)
        if self.clean_up_spaces:
            text = _clean_up(text)
        return text

    def batch_decode(self, rows, skip_special_tokens: bool = False):
        return [self.decode(r, skip_special_tokens) for r in rows]

    # ----- chat template ---------------------------------------------------

    def apply_chat_template(self, messages, add_generation_prompt=False,
                            tokenize=True, add_special_tokens=False, **_):
        if self.chat_template is None:
            raise ValueError("tokenizer has no chat_template")
        import jinja2
        from jinja2.ext import loopcontrols
        from jinja2.sandbox import ImmutableSandboxedEnvironment

        def raise_exception(message):
            raise jinja2.exceptions.TemplateError(message)

        def tojson(x, ensure_ascii=False, indent=None, separators=None,
                   sort_keys=False):
            return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                              separators=separators, sort_keys=sort_keys)

        env = ImmutableSandboxedEnvironment(
            trim_blocks=True, lstrip_blocks=True, extensions=[loopcontrols])
        env.filters["tojson"] = tojson
        env.globals["raise_exception"] = raise_exception
        text = env.from_string(self.chat_template).render(
            messages=messages, tools=None, documents=None,
            add_generation_prompt=add_generation_prompt,
            **self.special_tokens)
        if tokenize:
            return self.encode(text, add_special_tokens=add_special_tokens)
        return text


def _clean_up(text: str) -> str:
    """transformers' ``clean_up_tokenization``."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def write_tokenizer(path: str, model: str, vocab: dict[str, int],
                    specials: dict[str, str], *, lowercase: bool = True,
                    strip_accents: bool = False,
                    template: tuple[str, str] | None = None,
                    chat_template: str | None = None) -> None:
    """Write ``tokenizer.json`` + ``tokenizer_config.json`` in HF's format.

    model: "WordPiece" or "WordLevel"; vocab: token -> id (special tokens
    included); specials: e.g. {"pad_token": "[PAD]", "unk_token": ...};
    template: (first, last) special tokens of a ``first $A last``
    TemplateProcessing post-processor."""
    os.makedirs(path, exist_ok=True)
    norms = ([{"type": "Lowercase"}] if lowercase else []) + (
        [{"type": "StripAccents"}] if strip_accents else [])
    special_set = set(specials.values())
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": vocab[t], "content": t, "single_word": False,
             "lstrip": False, "rstrip": False, "normalized": False,
             "special": True}
            for t in sorted(special_set, key=lambda t: vocab[t])],
        "normalizer": {"type": "Sequence", "normalizers": norms},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Whitespace"},
            {"type": "Punctuation", "behavior": "Removed"}]},
        "post_processor": None,
        "decoder": None,
        "model": ({"type": "WordPiece", "unk_token": specials["unk_token"],
                   "continuing_subword_prefix": "##",
                   "max_input_chars_per_word": 100, "vocab": vocab}
                  if model == "WordPiece" else
                  {"type": "WordLevel", "vocab": vocab,
                   "unk_token": specials["unk_token"]}),
    }
    if template is not None:
        first, last = template
        spec["post_processor"] = {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": first, "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": last, "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": first, "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": last, "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": last, "type_id": 1}}],
            "special_tokens": {t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
                               for t in (first, last)},
        }
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    config = {"clean_up_tokenization_spaces": False,
              "tokenizer_class": "PreTrainedTokenizerFast", **specials}
    if chat_template is not None:
        config["chat_template"] = chat_template
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f, indent=2)
