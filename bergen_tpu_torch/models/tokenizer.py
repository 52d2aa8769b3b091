"""A reader for HF ``tokenizer.json`` / ``tokenizer_config.json`` files.

The port's machine has neither ``transformers`` nor ``tokenizers``, so the
port carries the part of them its checkpoints use, with the same results as
``AutoTokenizer`` on those files:

* models: WordPiece, WordLevel, Unigram (sentencepiece's Viterbi over
  ``(piece, score)``, consecutive unknown characters fused into one
  ``unk_id``), the family of DeBERTa-v3's tokenizer, and BPE with ranked
  merges, ``byte_fallback`` to ``<0xNN>`` tokens, ``fuse_unk`` and
  ``ignore_merges`` (Llama-2's and TinyLlama's ``tokenizer.json``, and the
  byte-level BPE of Llama-3's and Qwen2's);
* normalizers: Lowercase, StripAccents, Strip, Replace, Prepend, NFC,
  Precompiled (a serialized sentencepiece charsmap, which DeBERTa-v3's
  published ``tokenizer.json`` carries; ``_Precompiled``), and a Sequence
  of them;
* pre-tokenizers: Whitespace, WhitespaceSplit, Punctuation (Removed or
  Isolated), Metaspace, Split (a Regex pattern, as the published Llama-3
  and Qwen2 ones: ``split_regex``, or a String one, as Gemma's ``" "``;
  behaviors Isolated and MergedWithPrevious),
  Digits (Command-R's, with ``individual_digits``), ByteLevel (GPT-2's
  byte-to-unicode table, with or without GPT-2's own split), and a
  Sequence of them;
* the TemplateProcessing post-processor, single (``[CLS] $A [SEP]``) and
  pair (``[CLS] $A [SEP] $B:1 [SEP]:1``) with their type ids, and
  truncation that leaves room for its special tokens (``only_second`` for
  pairs, as ``tokenizers`` truncates a cross-encoder's documents); the
  ByteLevel post-processor (offsets only: the ids pass unchanged) and a
  Sequence of the two (Llama-3.1's);
* added tokens, matched in the raw text before normalisation;
* ``decode``/``batch_decode`` (no decoder: tokens joined by spaces, or the
  WordPiece, Metaspace or ByteLevel decoder, or a Sequence of Replace,
  ByteFallback, Fuse and Strip decoders: Llama-2's),
  ``skip_special_tokens``;
* ``apply_chat_template`` rendered with jinja2 as transformers renders it
  (with its ``raise_exception`` and ``strftime_now`` globals).

Any other component raises ``NotImplementedError`` naming it.
``write_tokenizer`` writes such files, and ``train_byte_level_bpe`` and
``train_sentencepiece_bpe`` learn merges from a text (both used to make
checkpoints without ``tokenizers``).
"""

from __future__ import annotations

import base64
import collections
import functools
import heapq
import json
import os
import re
import struct
import unicodedata
from datetime import datetime
from typing import Iterable

_WHITESPACE_RE = re.compile(r"\w+|[^\w\s]+")


def _is_punc(c: str) -> bool:
    return (c.isascii() and not c.isalnum() and c.isprintable()
            and not c.isspace()) or unicodedata.category(c).startswith("P")


def _normalizer(spec):
    """-> function: text -> normalized text.  Every rule but NFC is its
    aligned form (``_normalizer_aligned``) with the spans dropped, so the
    plain encode and the offsets follow one implementation of each."""
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
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    aligned = _normalizer_aligned(spec)
    return lambda s: aligned(s, [None] * len(s))[0]


def _transform(chars: str, spans: list, dest) -> tuple[str, list]:
    """``tokenizers``' ``NormalizedString::transform`` over a whole string
    kept with its characters' spans in the original text: each
    ``(c, change)`` of ``dest`` takes the next old character's span
    (change <= 0, which then drops -change more old characters) or, as an
    inserted character (change 1), the span of the old character before
    it."""
    out_c, out_s, pos = [], [], 0
    for c, change in dest:
        if change > 0:
            span = spans[pos - 1] if pos else (0, 0)
        else:
            span = spans[pos]
            pos += 1 - change
        out_c.append(c)
        out_s.append(span)
    return "".join(out_c), out_s


def _replace_aligned(chars: str, spans: list, matches, content: str):
    """Each (start, end) character range of ``matches`` replaced by
    ``content``, whose characters all take the span of the range's last
    character (``tokenizers``' ``NormalizedString::replace``)."""
    out_c, out_s, pos = [], [], 0
    for a, b in matches:
        out_c += [chars[pos:a], content]
        out_s += spans[pos:a] + [spans[b - 1]] * len(content)
        pos = b
    return "".join(out_c) + chars[pos:], out_s + spans[pos:]


def _lowercase_aligned(chars: str, spans: list):
    low = chars.lower()
    if len(low) == len(chars):  # no character grew: the spans stay
        return low, spans
    return _transform(chars, spans, [
        (lc, int(n > 0)) for c in chars for n, lc in enumerate(c.lower())])


def _normalizer_aligned(spec):
    """The normalizer of ``spec`` on a string kept with its characters'
    spans in the original text, each span as ``tokenizers`` aligns it.
    NFC raises: no shipped tokenizer that needs offsets has it."""
    if spec is None:
        return lambda chars, spans: (chars, spans)
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_normalizer_aligned(n) for n in spec["normalizers"]]

        def seq(chars, spans):
            for f in steps:
                chars, spans = f(chars, spans)
            return chars, spans

        return seq
    if kind == "Lowercase":
        return _lowercase_aligned
    if kind == "StripAccents":
        def strip_accents(chars, spans):
            keep = [n for n, c in enumerate(chars)
                    if unicodedata.category(c) != "Mn"]
            return "".join(chars[n] for n in keep), [spans[n] for n in keep]

        return strip_accents
    if kind == "Strip":
        left = spec.get("strip_left", True)
        right = spec.get("strip_right", True)

        def strip(chars, spans):
            a = len(chars) - len(chars.lstrip()) if left else 0
            b = max(a, len(chars.rstrip()) if right else len(chars))
            return chars[a:b], spans[a:b]

        return strip
    if kind == "Replace":
        pat, content = spec["pattern"], spec["content"]
        rx = re.compile(pat["Regex"] if "Regex" in pat
                        else re.escape(pat["String"]))
        return lambda chars, spans: _replace_aligned(
            chars, spans, [m.span() for m in rx.finditer(chars)
                           if m.end() > m.start()], content)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda chars, spans: _prepend_aligned(chars, spans, pre)
    if kind == "Precompiled":
        return _Precompiled(base64.b64decode(
            spec["precompiled_charsmap"])).normalize_aligned
    raise NotImplementedError(f"tokenizer normalizer {kind!r} with offsets")


def _prepend_aligned(chars: str, spans: list, pre: str):
    """``tokenizers``' ``NormalizedString::prepend``: the new characters
    take the first character's span."""
    if not chars:
        return chars, spans
    return pre + chars, [spans[0]] * len(pre) + spans


# Unicode's extended grapheme clusters (UAX #29), for the Precompiled
# normalizer: Python's ``re`` has no ``\X`` and ``unicodedata`` no
# Grapheme_Cluster_Break, so the classes come from the general category and
# these lists (Unicode 15).  The Indic conjunct rule (GB9c) is left out: it
# joins only clusters of 6 bytes or more, which the normalizer reads
# character by character either way.
_PREPEND = ((0x0600, 0x0605), (0x06DD, 0x06DD), (0x070F, 0x070F),
            (0x0890, 0x0891), (0x08E2, 0x08E2), (0x0D4E, 0x0D4E),
            (0x110BD, 0x110BD), (0x110CD, 0x110CD), (0x111C2, 0x111C3),
            (0x1193F, 0x1193F), (0x11941, 0x11941), (0x11A3A, 0x11A3A),
            (0x11A84, 0x11A89), (0x11D46, 0x11D46), (0x11F02, 0x11F02))
# Other_Grapheme_Extend (spacing marks and others that extend), the emoji
# modifiers and the tags
_EXTEND = ((0x09BE, 0x09BE), (0x09D7, 0x09D7), (0x0B3E, 0x0B3E),
           (0x0B57, 0x0B57), (0x0BBE, 0x0BBE), (0x0BD7, 0x0BD7),
           (0x0CC2, 0x0CC2), (0x0CD5, 0x0CD6), (0x0D3E, 0x0D3E),
           (0x0D57, 0x0D57), (0x0DCF, 0x0DCF), (0x0DDF, 0x0DDF),
           (0x1B35, 0x1B35), (0x200C, 0x200C), (0x302E, 0x302F),
           (0xFF9E, 0xFF9F), (0x1133E, 0x1133E), (0x11357, 0x11357),
           (0x114B0, 0x114B0), (0x114BD, 0x114BD), (0x115AF, 0x115AF),
           (0x11930, 0x11930), (0x1D165, 0x1D165), (0x1D16E, 0x1D172),
           (0x1F3FB, 0x1F3FF), (0xE0020, 0xE007F))
# spacing combining marks (Mc) that are not SpacingMark
_NOT_SPACING = ((0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064),
                (0x1067, 0x106D), (0x1083, 0x1083), (0x1087, 0x108C),
                (0x108F, 0x108F), (0x109A, 0x109C), (0x1A61, 0x1A61),
                (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
                (0x11720, 0x11721))
_EXT_PICT = ((0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C),
             (0x2049, 0x2049), (0x2122, 0x2122), (0x2139, 0x2139),
             (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B),
             (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
             (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2),
             (0x25AA, 0x25AB), (0x25B6, 0x25B6), (0x25C0, 0x25C0),
             (0x25FB, 0x25FE), (0x2600, 0x2605), (0x2607, 0x2612),
             (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
             (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D),
             (0x2721, 0x2721), (0x2728, 0x2728), (0x2733, 0x2734),
             (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C),
             (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
             (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1),
             (0x27B0, 0x27B0), (0x27BF, 0x27BF), (0x2934, 0x2935),
             (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50),
             (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
             (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF),
             (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
             (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A),
             (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
             (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
             (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
             (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
             (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
             (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A),
             (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))


_ASCII_CLUSTERS = re.compile(r"\r\n|.", re.DOTALL)


def _in(cp: int, ranges) -> bool:
    return any(a <= cp <= b for a, b in ranges)


@functools.lru_cache(maxsize=4096)
def _gcb(c: str) -> tuple[str, bool]:
    """The Grapheme_Cluster_Break class of ``c``, and whether ``c`` is
    Extended_Pictographic."""
    return _gcb_class(c), _in(ord(c), _EXT_PICT)


def _gcb_class(c: str) -> str:
    cp = ord(c)
    if c in "\r\n":
        return "CR" if c == "\r" else "LF"
    if cp == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if _in(cp, _PREPEND):
        return "Prepend"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me") or _in(cp, _EXTEND):
        return "Extend"
    if cat in ("Cc", "Cf", "Zl", "Zp", "Cs"):
        return "Control"
    if (cat == "Mc" and not _in(cp, _NOT_SPACING)) or cp in (0x0E33, 0x0EB3):
        return "SpacingMark"
    return "Other"


def _graphemes(text: str) -> list[str]:
    """``text`` cut into extended grapheme clusters (UAX #29 rules GB3 to
    GB13, without GB9c)."""
    if text.isascii():  # every ASCII character is a cluster, but CR LF
        return _ASCII_CLUSTERS.findall(text)
    out: list[str] = []
    cur = ""
    prev = None
    pict = pict_zwj = False  # text ends with ExtPict Extend* (ZWJ)
    ri = 0  # regional indicators just before
    for c in text:
        k, ext_pict = _gcb(c)
        if prev is None:
            join = False
        elif prev == "CR" and k == "LF":
            join = True
        elif prev in ("Control", "CR", "LF") or k in ("Control", "CR", "LF"):
            join = False
        elif prev == "L" and k in ("L", "V", "LV", "LVT"):
            join = True
        elif prev in ("LV", "V") and k in ("V", "T"):
            join = True
        elif prev in ("LVT", "T") and k == "T":
            join = True
        elif k in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            join = True
        elif pict_zwj and ext_pict:
            join = True
        else:
            join = prev == "RI" and k == "RI" and ri % 2 == 1
        if not join and cur:
            out.append(cur)
            cur = ""
        cur += c
        pict_zwj = k == "ZWJ" and pict
        pict = ext_pict or (k == "Extend" and pict)
        ri = ri + 1 if k == "RI" else 0
        prev = k
    if cur:
        out.append(cur)
    return out


class _Precompiled:
    """``tokenizers``' Precompiled normalizer over sentencepiece's serialized
    charsmap: a little-endian uint32 byte size of the trie, the trie (a
    Darts-clone double array of uint32 units over UTF-8 byte strings, whose
    values are offsets into the pool), then the pool of NUL-terminated
    replacement strings.

    Applied as ``tokenizers`` applies it: per grapheme cluster of fewer than
    6 bytes, the first (shortest) key that prefixes the cluster's bytes
    replaces the whole cluster; otherwise each character is looked up alone
    and kept where no key prefixes it."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("Precompiled normalizer: the charsmap is "
                             f"{len(blob)} bytes, too short for its header")
        (size,) = struct.unpack_from("<I", blob)
        n = size // 4
        if 4 + 4 * n > len(blob):
            raise ValueError(f"Precompiled normalizer: the trie of {size} "
                             f"bytes overruns the {len(blob)}-byte charsmap")
        self.units = struct.unpack_from(f"<{n}I", blob, 4)
        self.pool = blob[4 + 4 * n:]
        self.pool.decode("utf-8")  # as tokenizers, refuse a pool that is not
        self._cache: dict[str, str | None] = {}

    def _lookup(self, key: bytes) -> str | None:
        """The replacement of the shortest key that prefixes ``key``."""
        units = self.units

        def offset(u):
            return (u >> 10) << ((u & (1 << 9)) >> 6)

        if not units:
            return None
        pos = offset(units[0])
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(units):
                return None
            u = units[pos]
            if u & ((1 << 31) | 0xFF) != c:
                return None
            pos ^= offset(u)
            if (u >> 8) & 1:
                start = units[pos] & ((1 << 31) - 1)
                end = self.pool.find(b"\0", start)
                return self.pool[start:end if end >= 0 else None].decode()
        return None

    def _transform(self, piece: str) -> str | None:
        out = self._cache.get(piece, self)
        if out is self:
            out = self._cache[piece] = self._lookup(piece.encode())
        return out

    def _pieces(self, text: str):
        """(piece of the text, its replacement or None), in order."""
        for cluster in _graphemes(text):
            if len(cluster.encode()) < 6:
                rep = self._transform(cluster)
                if rep is not None:
                    yield cluster, rep
                    continue
            for c in cluster:
                yield c, self._transform(c)

    def normalize(self, text: str) -> str:
        return self.normalize_aligned(text, [None] * len(text))[0]

    def normalize_aligned(self, chars: str, spans: list):
        """``normalize`` on (characters, spans): a replacement's
        characters take its piece's spans in turn, the ones past the
        piece's length that of its last character, and a shorter
        replacement's last character absorbs the rest (``tokenizers``'
        ``replace`` in its Precompiled normalizer)."""
        pieces, out, same = [], [], True
        for piece, rep in self._pieces(chars):
            pieces.append((piece, rep))
            if rep is None:
                out.append(piece)
            else:
                out.append(rep)
                same = same and len(rep) == len(piece)
        if same:  # no piece changed its length: every span stays
            return "".join(out), spans
        dest = []
        for piece, rep in pieces:
            if rep is None:
                dest.append((piece, 0))
                continue
            grow = len(rep) - len(piece)
            new = [[c, 0] for c in rep]
            if grow > 0:
                for d in new[len(new) - grow:]:
                    d[1] = 1
            elif grow < 0 and new:
                new[-1][1] += grow
            elif grow < 0 and dest:
                dest[-1] = (dest[-1][0], dest[-1][1] + grow)
            dest.extend(map(tuple, new))
        return _transform(chars, spans, dest)


def _metaspace(spec):
    """``_metaspace_aligned(spec)`` on plain pieces (the spans dropped)."""
    aligned = _metaspace_aligned(spec)

    def pre(pieces, at_start):
        return [chars for chars, _ in aligned(
            [(p, [None] * len(p)) for p in pieces], at_start)]

    return pre


def _metaspace_aligned(spec):
    """``tokenizers``' Metaspace on pieces kept with their characters'
    spans: spaces become the replacement character (with the space's
    span), which is prepended to the piece (scheme ``always``, or
    ``first``: only where the text starts the input; with the piece's first
    span) and, with ``split``, starts each piece."""
    rep = spec.get("replacement", "\u2581")
    scheme = spec.get("prepend_scheme")
    if scheme is None:  # the older add_prefix_space flag
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    split = spec.get("split", True)

    def pre(pieces, at_start):
        out = []
        for n, (chars, spans) in enumerate(pieces):
            chars = chars.replace(" ", rep)
            if chars and chars[0] != rep and (
                    scheme == "always"
                    or (scheme == "first" and at_start and n == 0)):
                chars, spans = _prepend_aligned(chars, spans, rep)
            if not split:
                out.append((chars, spans))
                continue
            start = 0
            while start < len(chars):
                end = chars.find(rep, start + 1)
                end = len(chars) if end < 0 else end
                out.append((chars[start:end], spans[start:end]))
                start = end
        return out

    return pre


# The Split patterns of the published byte-level tokenizers, and GPT-2's
# own (the ByteLevel pre-tokenizer's with ``use_regex``), as
# ``tokenizer.json`` writes them
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                r"\s+(?!\S)|\s+")
QWEN2_SPLIT = LLAMA3_SPLIT.replace(r"\p{N}{1,3}", r"\p{N}")
GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
              r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
# Unicode's White_Space property, which the Oniguruma engine of
# ``tokenizers`` takes for \s; Python's \s also takes U+001C to U+001F
_WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028"
                "\u2029\u202f\u205f\u3000")


@functools.lru_cache(maxsize=1)
def _category_classes() -> dict[str, str]:
    """{"L": the body of a character class of every code point of general
    category L*, "N": of N*}, as ranges of ``\\U`` escapes."""
    runs: dict[str, list] = {"L": [], "N": []}
    for cp in range(0x110000):
        major = unicodedata.category(chr(cp))[0]
        if major in runs:
            r = runs[major]
            if r and r[-1][1] == cp - 1:
                r[-1][1] = cp
            else:
                r.append([cp, cp])
    return {k: "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                       for a, b in r) for k, r in runs.items()}


@functools.lru_cache(maxsize=None)
def split_regex(pattern: str) -> re.Pattern:
    """A Python ``re`` that splits as ``tokenizers``' Oniguruma does with
    ``pattern``, one of the published patterns above: \\p{L} and \\p{N}
    become classes of the general categories L* and N* (not
    ``str.isnumeric``, which admits CJK numerals of category Lo), spliced
    inside the pattern's brackets where they stand there, and \\s and \\S
    become Unicode's White_Space and its complement.  ``(?i:...)``,
    ``{1,3}`` and ``(?!...)`` mean the same to both engines."""
    if pattern not in (LLAMA3_SPLIT, QWEN2_SPLIT, GPT2_SPLIT):
        raise NotImplementedError(
            f"tokenizer Split pattern {pattern!r}: only the Llama-3, Qwen2 "
            "and GPT-2 patterns are translated")
    cats = _category_classes()
    body = {r"\p{L}": cats["L"], r"\p{N}": cats["N"], r"\s": _WHITE_SPACE}
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        tok = pattern[i:i + 5] if pattern.startswith(r"\p{", i) else \
            pattern[i:i + 2] if c == "\\" else c
        i += len(tok)
        if tok in body:
            out.append(body[tok] if in_class else f"[{body[tok]}]")
        elif tok == r"\S" and not in_class:
            out.append(f"[^{_WHITE_SPACE}]")
        else:
            in_class = (in_class and tok != "]") or tok == "["
            out.append(tok)
    return re.compile("".join(out))


def _segments(rx: re.Pattern, text: str) -> list[tuple[bool, str]]:
    """(is a match, text) for every non-empty match of ``rx`` and every
    stretch between matches, in order."""
    out, pos = [], 0
    for m in rx.finditer(text):
        if m.start() > pos:
            out.append((False, text[pos:m.start()]))
        if m.end() > m.start():
            out.append((True, m.group(0)))
        pos = m.end()
    if pos < len(text):
        out.append((False, text[pos:]))
    return out


def _split_isolated(rx: re.Pattern, text: str) -> list[str]:
    """``tokenizers``' Split with behavior ``Isolated``: every match is a
    piece, and so is every stretch between matches."""
    return [t for _, t in _segments(rx, text)]


def _split_merged(rx: re.Pattern, text: str) -> list[str]:
    """``tokenizers``' Split with behavior ``MergedWithPrevious``: a match
    joins the piece before it unless that piece ended in a match (or there
    is none)."""
    out, prev = [], False
    for is_match, t in _segments(rx, text):
        if is_match and not prev and out:
            out[-1] += t
        else:
            out.append(t)
        prev = is_match
    return out


def _is_numeric(c: str) -> bool:
    """Rust's ``char::is_numeric`` (``tokenizers``' Digits): the general
    categories Nd, Nl and No."""
    return unicodedata.category(c) in ("Nd", "Nl", "No")


def _digits(spec):
    """``tokenizers``' Digits pre-tokenizer: runs of numeric characters
    become pieces of their own, or (``individual_digits``) each numeric
    character does."""
    individual = spec.get("individual_digits", False)

    def pre(pieces, _):
        out = []
        for p in pieces:
            cur, cur_num = "", False
            for c in p:
                num = _is_numeric(c)
                if cur and (num != cur_num or (num and individual)):
                    out.append(cur)
                    cur = ""
                cur += c
                cur_num = num
            if cur:
                out.append(cur)
        return out

    return pre


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte-to-unicode table: the printable Latin-1 bytes map to
    themselves, every other byte to U+0100 onwards, in byte order."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return table


def _to_byte_level(text: str) -> str:
    table = bytes_to_unicode()
    return "".join(table[b] for b in text.encode())


def _byte_level(spec):
    """``tokenizers``' ByteLevel pre-tokenizer: each piece gets a leading
    space (``add_prefix_space``) where it has none, is split by GPT-2's
    pattern (``use_regex``), and its UTF-8 bytes become the table's
    characters."""
    prefix = spec.get("add_prefix_space", True)
    rx = split_regex(GPT2_SPLIT) if spec.get("use_regex", True) else None

    def pre(pieces, _):
        out = []
        for p in pieces:
            if prefix and not p.startswith(" "):
                p = " " + p
            out.extend(_to_byte_level(q)
                       for q in (_split_isolated(rx, p) if rx else [p]))
        return out

    return pre


def _pre_tokenizer_aligned(spec):
    """``_pre_tokenizer(spec)`` on pieces kept as (characters, spans); only
    Metaspace (and none), the pre-tokenizers of the sentencepiece
    tokenizers whose offsets the port reads."""
    if spec is None:
        return lambda pieces, at_start: pieces
    if spec["type"] == "Metaspace":
        return _metaspace_aligned(spec)
    raise NotImplementedError(
        f"tokenizer pre-tokenizer {spec['type']!r} with offsets")


def _pre_tokenizer(spec):
    """-> function: (list of pieces, whether the first piece starts the
    input) -> list of pieces."""
    if spec is None:
        return lambda pieces, at_start: pieces
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces, at_start):
            for f in steps:
                pieces = f(pieces, at_start)
            return pieces

        return seq
    if kind == "Metaspace":
        return _metaspace(spec)
    if kind == "ByteLevel":
        return _byte_level(spec)
    if kind == "Split":
        pat, behavior = spec["pattern"], spec.get("behavior")
        split = {"Isolated": _split_isolated,
                 "MergedWithPrevious": _split_merged}.get(behavior)
        if spec.get("invert") or split is None:
            raise NotImplementedError(
                f"tokenizer Split behavior {behavior!r} (invert="
                f"{spec.get('invert')}): only Isolated and "
                "MergedWithPrevious")
        if "Regex" in pat:
            rx = split_regex(pat["Regex"])
        elif "String" in pat:
            rx = re.compile(re.escape(pat["String"]))
        else:
            raise NotImplementedError(f"tokenizer Split pattern {pat!r}")
        return lambda pieces, _: [q for p in pieces for q in split(rx, p)]
    if kind == "Digits":
        return _digits(spec)
    if kind == "Whitespace":
        return lambda pieces, _: [m for p in pieces
                                  for m in _WHITESPACE_RE.findall(p)]
    if kind == "WhitespaceSplit":
        return lambda pieces, _: [m for p in pieces for m in p.split()]
    if kind == "Punctuation":
        behavior = spec.get("behavior", "Isolated")
        if behavior not in ("Removed", "Isolated"):
            raise NotImplementedError(
                f"tokenizer Punctuation behavior {behavior!r}")
        keep = behavior == "Isolated"

        def punct(pieces, _):
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
        return [i for i, _, _ in self.tokenize_spans(word)]

    def tokenize_spans(self, word: str) -> list[tuple[int, int, int]]:
        """(id, start, end) of each token: its characters of ``word``."""
        whole = [(self.vocab[self.unk], 0, len(word))]
        if len(word) > self.max_chars:
            return whole
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
                return whole
            out.append((cur, start, end))
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


class _Unigram:
    """sentencepiece's unigram model as ``tokenizers`` runs it: the best
    path over the pieces (highest total score, the first candidate kept on
    a tie), a character no piece covers scored min_score - 10 as
    ``unk_id``, and consecutive unknown characters fused into one token."""

    UNK_PENALTY = 10.0

    def __init__(self, spec):
        if spec.get("byte_fallback"):
            raise NotImplementedError("tokenizer Unigram byte_fallback")
        pieces = spec["vocab"]
        self.vocab = {p: i for i, (p, _) in enumerate(pieces)}
        self.scores = [float(sc) for _, sc in pieces]
        self.unk_id = spec.get("unk_id")
        self.unk_score = min(self.scores) - self.UNK_PENALTY
        self.max_len = max(len(p) for p, _ in pieces)

    def tokenize(self, text: str) -> list[int]:
        return [i for i, _, _ in self.tokenize_spans(text)]

    def tokenize_spans(self, text: str) -> list[tuple[int, int, int]]:
        """(id, start, end) of each token: its characters of ``text`` (a
        fused unknown covers all its characters)."""
        n = len(text)
        if n == 0:
            return []
        best = [0.0] + [None] * n        # best score of a path ending here
        back: list = [None] * (n + 1)    # (start, id) of its last token
        for start in range(n):
            base = best[start]
            single = False
            for end in range(start + 1, min(n, start + self.max_len) + 1):
                i = self.vocab.get(text[start:end])
                if i is None:
                    continue
                cand = base + self.scores[i]
                if best[end] is None or cand > best[end]:
                    best[end], back[end] = cand, (start, i)
                single = single or end == start + 1
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"Unigram: no piece for {text[start]!r} "
                                     "and no unk_id")
                cand = base + self.unk_score
                if best[start + 1] is None or cand > best[start + 1]:
                    best[start + 1], back[start + 1] = cand, (start, None)
        toks, end, unk_end = [], n, None
        while end > 0:
            start, i = back[end]
            if i is None or i == self.unk_id:
                unk_end = end if unk_end is None else unk_end
            else:
                if unk_end is not None:
                    toks.append((self.unk_id, end, unk_end))
                    unk_end = None
                toks.append((i, start, end))
            end = start
        if unk_end is not None:
            toks.append((self.unk_id, 0, unk_end))
        return toks[::-1]


class _BPE:
    """``tokenizers``' BPE model: each character is a symbol (its vocab id;
    else, with ``byte_fallback``, its UTF-8 bytes as ``<0xNN>`` tokens when
    all exist; else ``unk_token``, consecutive ones fused with
    ``fuse_unk``), then the adjacent pair of lowest merge rank is merged,
    the leftmost first, until none is left (the library's queue, stale
    entries included, so the merge order is its own)."""

    def __init__(self, spec):
        for opt in ("dropout", "continuing_subword_prefix",
                    "end_of_word_suffix"):
            if spec.get(opt):
                raise NotImplementedError(
                    f"tokenizer BPE {opt}={spec[opt]!r}")
        self.vocab = spec["vocab"]
        self.unk_id = (self.vocab[spec["unk_token"]]
                       if spec.get("unk_token") is not None else None)
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        self.merges = {}  # (left id, right id) -> (rank, merged id)
        for rank, m in enumerate(spec["merges"]):
            a, b = m.split(" ") if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (rank,
                                                           self.vocab[a + b])

    def _symbols(self, word: str) -> list[int]:
        ids: list[int] = []
        unk = None  # a pending unknown, added before the next vocab char
        for ch in word:
            i = self.vocab.get(ch)
            if i is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(i)
                continue
            if self.byte_fallback:
                bs = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode()]
                if None not in bs:
                    ids.extend(bs)
                    continue
            if self.unk_id is not None:
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self.unk_id
        if unk is not None:
            ids.append(unk)
        return ids

    def tokenize(self, word: str) -> list[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        sym = self._symbols(word)
        n = len(sym)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        gone = [False] * n
        queue = []

        def push(pos):
            m = self.merges.get((sym[pos], sym[nxt[pos]]))
            if m is not None:
                heapq.heappush(queue, (m[0], pos, m[1]))

        for pos in range(n - 1):
            push(pos)
        while queue:
            _, pos, new = heapq.heappop(queue)
            if gone[pos] or nxt[pos] < 0:
                continue
            right = nxt[pos]
            m = self.merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new:
                continue  # an expired entry
            sym[pos] = new
            gone[right] = True
            nxt[pos] = nxt[right]
            if nxt[pos] >= 0:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0:
                push(prv[pos])
            if nxt[pos] >= 0:
                push(pos)
        return [t for t, g in zip(sym, gone) if not g]


def _byte_fallback(tokens: list[str]) -> list[str]:
    """``tokenizers``' ByteFallback decoder: runs of ``<0xNN>`` tokens
    become their UTF-8 text, or one U+FFFD a byte where that is invalid."""
    out: list[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("\ufffd" * len(run))
            run.clear()

    for t in tokens:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                run.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def _strip(content: str, start: int, stop: int):
    def strip(tokens):
        out = []
        for t in tokens:
            a = 0
            while a < min(start, len(t)) and t[a] == content:
                a += 1
            b = len(t)
            while len(t) - b < stop and b > a and t[b - 1] == content:
                b -= 1
            out.append(t[a:b])
        return out

    return strip


def _byte_level_decode(tokens: list[str]) -> list[str]:
    """``tokenizers``' ByteLevel decoder: each token's characters back to
    their bytes (a token with a character outside the table, such as an
    added token with a space, keeps its own UTF-8 bytes), all joined and
    decoded as UTF-8 with one U+FFFD for each invalid sequence."""
    back = {c: b for b, c in bytes_to_unicode().items()}
    out = bytearray()
    for t in tokens:
        bs = [back.get(c) for c in t]
        out.extend(t.encode() if None in bs else bs)
    return [out.decode("utf-8", errors="replace")]


def _decoder_chain(spec):
    """-> function: list of token strings -> list of strings, for the
    decoders Llama-2's ``tokenizer.json`` chains, and the ByteLevel
    decoder."""
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_decoder_chain(d) for d in spec["decoders"]]

        def seq(tokens):
            for f in steps:
                tokens = f(tokens)
            return tokens

        return seq
    if kind == "Replace" and "String" in spec["pattern"]:
        old, new = spec["pattern"]["String"], spec["content"]
        return lambda tokens: [t.replace(old, new) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return _strip(spec["content"], spec["start"], spec["stop"])
    raise NotImplementedError(f"tokenizer decoder {kind!r}")


def _template(post):
    """The TemplateProcessing spec that decides a post-processor's ids:
    the ByteLevel post-processor changes offsets only, and a Sequence
    applies its steps in turn."""
    if post is None or post["type"] == "ByteLevel":
        return None
    if post["type"] == "TemplateProcessing":
        return post
    if post["type"] == "Sequence":
        found = [t for t in map(_template, post["processors"]) if t]
        if len(found) > 1:
            raise NotImplementedError(
                "tokenizer post-processor Sequence with two templates")
        return found[0] if found else None
    raise NotImplementedError(f"tokenizer post-processor {post['type']!r}")


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
        elif model["type"] == "Unigram":
            self.model = _Unigram(model)
        elif model["type"] == "BPE":
            self.model = _BPE(model)
        else:
            raise NotImplementedError(f"tokenizer model {model['type']!r}")
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._spec = spec
        self.template = _template(spec.get("post_processor"))
        dec = spec.get("decoder")
        self.decoder = dec
        self._decode_chain = None
        if dec is not None and dec["type"] not in ("WordPiece", "Metaspace"):
            self._decode_chain = _decoder_chain(dec)
        self.added = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        self.special_ids = {t["id"] for t in spec.get("added_tokens", [])
                            if t.get("special")}
        self.id_to_token = {i: t for t, i in self.model.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self._added_re = (re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added else None)
        # tokens added with ``add_tokens`` (content -> id), matched in the
        # normalized text by their normalized content (-> id)
        self.added_normalized: dict[str, int] = {}
        self._normalized_ids: dict[str, int] = {}
        self._normalized_re = None
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

    @classmethod
    def from_gguf(cls, meta: dict) -> "Tokenizer":
        """The tokenizer of a llama GGUF file's metadata ``meta``
        (``tokenizer.ggml.*``), as transformers builds it for
        ``AutoTokenizer.from_pretrained(gguf_file=...)``:
        ``GGUFLlamaConverter`` (``transformers/integrations/ggml.py``) gives
        a BPE over the token list with byte fallback and ``fuse_unk``, its
        merges from the file or, where it has none, from the tokens and
        scores (``gguf_merges``); every token of type 3 special (without
        types: unk, bos and eos); the legacy Llama normalizer (``▁``
        prepended unless ``add_space_prefix`` is false, spaces replaced)
        and the GGUF decoder chain (ByteFallback, Fuse, ``▁`` to space,
        the leading space stripped).  ``LlamaTokenizerFast`` then adds bos
        before every sequence (its default: transformers maps neither
        ``add_bos_token`` nor ``add_eos_token`` from the file).  The
        converter sets the eos token to ``tokens[bos_token_id]`` and the
        bos token to the same string (``ggml.py:403-404``, applied after
        the file's own ids), so both are the bos string, and the pad token
        is unset; the port keeps that (ROADMAP.md, the reference's own
        semantics)."""
        if meta.get("tokenizer.ggml.model") != "llama":
            raise NotImplementedError(
                f"GGUF tokenizer model {meta.get('tokenizer.ggml.model')!r}"
                ": the port reads the llama (sentencepiece BPE) vocabulary")
        tokens = meta["tokenizer.ggml.tokens"]
        merges = meta.get("tokenizer.ggml.merges")
        merges = ([tuple(m.split(" ")) for m in merges] if merges is not None
                  else gguf_merges(tokens, meta["tokenizer.ggml.scores"]))
        vocab = {t: i for i, t in enumerate(tokens)}

        def tok(key):
            i = meta.get(f"tokenizer.ggml.{key}")
            return None if i is None else tokens[i]

        unk = tok("unknown_token_id")
        # the converter's swap: eos <- bos's string, bos <- the "eos"
        # variable, which is also bos's string
        bos = tok("bos_token_id") if "tokenizer.ggml.eos_token_id" in meta \
            else None
        eos = tok("bos_token_id")
        # the converter's type-3 tokens, and LlamaTokenizerFast's (unk, bos,
        # eos: all the converter adds for a file without token types)
        types = meta.get("tokenizer.ggml.token_type") or []
        added = {t: vocab[t] for t in
                 [t for t, k in zip(tokens, types) if k == 3]
                 + [t for t in (unk, bos, eos) if t is not None]}
        prefix = bool(meta.get("tokenizer.ggml.add_space_prefix", True))
        spec = {
            "version": "1.0", "truncation": None, "padding": None,
            "added_tokens": _added_spec(added),
            "normalizer": {"type": "Sequence", "normalizers": (
                [{"type": "Prepend", "prepend": "▁"}] if prefix else [])
                + [{"type": "Replace", "pattern": {"String": " "},
                    "content": "▁"}]},
            "pre_tokenizer": None,
            "post_processor": None if bos is None else _template_spec(
                (bos, None), added),
            "decoder": {"type": "Sequence", "decoders": [
                {"type": "ByteFallback"}, {"type": "Fuse"},
                {"type": "Replace", "pattern": {"String": "▁"},
                 "content": " "}] + ([{"type": "Strip", "content": " ",
                                       "start": 1, "stop": 0}]
                                     if prefix else [])},
            "model": {"type": "BPE", "dropout": None, "unk_token": unk,
                      "fuse_unk": True, "byte_fallback": True,
                      "vocab": vocab, "merges": merges}}
        config = {"bos_token": bos, "eos_token": eos, "unk_token": unk,
                  "clean_up_tokenization_spaces": False}
        return cls(spec, config, meta.get("tokenizer.chat_template"))

    # ----- special tokens --------------------------------------------------

    def token_to_id(self, token: str | None) -> int | None:
        if token is None:
            return None
        if token in self.added:
            return self.added[token]
        if token in self.added_normalized:
            return self.added_normalized[token]
        return self.model.vocab.get(token)

    def add_tokens(self, tokens) -> int:
        """transformers' ``add_tokens``: each token not yet known becomes a
        non-special added token matched in the normalized text (its content
        normalized, ``normalized=True``), at the id ``tokenizers`` gives it:
        the vocabulary's size, or one past the largest added id when that
        is already past it.  Returns how many were added.  (The encode with
        offsets does not match them.)"""
        n = 0
        for t in tokens:
            if self.token_to_id(t) is not None:
                continue
            size = len(self.model.vocab)
            top = max([*self.added.values(), *self.added_normalized.values()],
                      default=None)
            new_id = top + 1 if top is not None and (top >= size
                                                     or size == 0) else size
            self.added_normalized[t] = new_id
            self.id_to_token[new_id] = t
            n += 1
        if n:
            self._normalized_ids = {self.normalize(t): i for t, i in
                                    self.added_normalized.items()}
            self._normalized_re = re.compile("|".join(
                re.escape(t) for t in sorted(self._normalized_ids, key=len,
                                             reverse=True)))
        return n

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

    def _segments(self, text: str):
        """(start, end, id) of the added tokens of ``text`` and (start,
        end, None) of the non-empty runs between them, in order."""
        pos = 0
        if self._added_re is not None:
            for m in self._added_re.finditer(text):
                if m.start() > pos:
                    yield pos, m.start(), None
                yield m.start(), m.end(), self.added[m.group(0)]
                pos = m.end()
        if len(text) > pos:
            yield pos, len(text), None

    def _encode_raw(self, text: str) -> list[int]:
        ids: list[int] = []
        for a, b, added_id in self._segments(text):
            if added_id is not None:
                ids.append(added_id)
                continue
            norm = self.normalize(text[a:b])
            pos = 0
            if self._normalized_re is not None:
                for m in self._normalized_re.finditer(norm):
                    for word in self.pre_tokenize([norm[pos:m.start()]],
                                                  a == 0 and pos == 0) \
                            if m.start() > pos else ():
                        ids.extend(self.model.tokenize(word))
                    ids.append(self._normalized_ids[m.group(0)])
                    pos = m.end()
            rest = norm[pos:]
            for word in self.pre_tokenize([rest], a == 0 and pos == 0) \
                    if rest else ():
                ids.extend(self.model.tokenize(word))
        return ids

    @functools.cached_property
    def _aligned(self):
        """(normalizer, pre-tokenizer, model) with spans, for offsets."""
        tokenize = getattr(self.model, "tokenize_spans", None)
        if tokenize is None:
            raise NotImplementedError(
                f"tokenizer model {type(self.model).__name__} with offsets "
                "(Unigram and WordPiece only)")
        return (_normalizer_aligned(self._spec.get("normalizer")),
                _pre_tokenizer_aligned(self._spec.get("pre_tokenizer")),
                tokenize)

    def _encode_raw_offsets(self, text: str):
        """(ids, offsets) of ``text`` without special tokens: each token's
        (start, end) characters of ``text``, as ``tokenizers`` maps an
        encoding back through its normalizer and pre-tokenizer."""
        normalize, pre_tokenize, tokenize = self._aligned
        ids: list[int] = []
        offsets: list[tuple[int, int]] = []
        for a, b, added_id in self._segments(text):
            if added_id is not None:
                ids.append(added_id)
                offsets.append((a, b))
                continue
            chars, spans = normalize(text[a:b],
                                     [(k, k + 1) for k in range(a, b)])
            for pc, ps in pre_tokenize([(chars, spans)], a == 0) \
                    if chars else ():
                for i, t0, t1 in tokenize(pc):
                    ids.append(i)
                    offsets.append((ps[t0][0], ps[t1 - 1][1]))
        return ids, offsets

    def encode_offsets(self, text: str, text_pair: str | None = None,
                       truncation=False, max_length: int | None = None):
        """(ids, type ids, offsets) of one text or (text, text_pair) pair
        with special tokens, truncated as ``encode_plus``; a special token's
        offsets are (0, 0), a token of ``text_pair`` counts characters of
        ``text_pair`` (transformers' ``return_offsets_mapping``)."""
        a, oa = self._encode_raw_offsets(text)
        b, ob = (self._encode_raw_offsets(text_pair)
                 if text_pair is not None else (None, None))
        a, b = self._truncate(a, b, True, truncation, max_length)
        oa = oa[:len(a)]
        ob = None if b is None else ob[:len(b)]
        ids, types = self._post_process(a, b)
        return ids, types, self._post_process(oa, ob, special=(0, 0))[0]

    def _post_process(self, a: list, b: list | None, special=None):
        """(ids, type ids) of the template around sequence a (and b); with
        ``special``, each special token's entry is ``special`` in place of
        its id (the offsets' (0, 0))."""
        if self.template is None:
            ids = a + (b or [])
            return ids, [0] * len(a) + [1] * len(b or [])
        ids, types = [], []
        for piece in self.template["pair" if b is not None else "single"]:
            if "Sequence" in piece:
                seq = a if piece["Sequence"]["id"] == "A" else b
                ids.extend(seq)
                types.extend([piece["Sequence"]["type_id"]] * len(seq))
            else:
                name = piece["SpecialToken"]["id"]
                sp = self.template["special_tokens"][name]["ids"]
                ids.extend(sp if special is None else [special] * len(sp))
                types.extend([piece["SpecialToken"]["type_id"]] * len(sp))
        return ids, types

    def _n_added(self, pair: bool) -> int:
        if self.template is None:
            return 0
        return sum(len(self.template["special_tokens"][
            p["SpecialToken"]["id"]]["ids"])
            for p in self.template["pair" if pair else "single"]
            if "SpecialToken" in p)

    def encode_plus(self, text: str, text_pair: str | None = None,
                    add_special_tokens: bool = True, truncation=False,
                    max_length: int | None = None):
        """(ids, type ids) of one text or one (text, text_pair) pair.
        truncation: True / "longest_first" for a single text,
        "only_second" for a pair (the specials count against
        max_length)."""
        a = self._encode_raw(text)
        b = self._encode_raw(text_pair) if text_pair is not None else None
        a, b = self._truncate(a, b, add_special_tokens, truncation,
                              max_length)
        if not add_special_tokens:
            ids = a + (b or [])
            return ids, [0] * len(a) + [1] * len(b or [])
        return self._post_process(a, b)

    def _truncate(self, a: list, b: list | None, add_special_tokens: bool,
                  truncation, max_length: int | None):
        """``encode_plus``'s truncation of sequence a (and b)."""
        if truncation and max_length is not None:
            room = max_length - (self._n_added(b is not None)
                                 if add_special_tokens else 0)
            if b is None:
                a = a[:max(0, room)]
            elif truncation == "only_second":
                over = len(a) + len(b) - room
                if over > 0:
                    if len(b) <= over:
                        raise ValueError(
                            "truncation only_second: the second sequence "
                            f"has {len(b)} tokens, {over} must go")
                    b = b[:len(b) - over]
            else:
                raise NotImplementedError(
                    f"pair truncation {truncation!r} (only 'only_second')")
        return a, b

    def encode(self, text: str, add_special_tokens: bool = True,
               truncation: bool = False,
               max_length: int | None = None) -> list[int]:
        return self.encode_plus(text, None, add_special_tokens, truncation,
                                max_length)[0]

    def __call__(self, texts, text_pair=None, truncation=False,
                 max_length: int | None = None,
                 add_special_tokens: bool = True,
                 return_offsets_mapping: bool = False):
        """{"input_ids", "token_type_ids"} for one text (or pair), or lists
        of them (unpadded: callers pad); with ``return_offsets_mapping``
        (one text or pair, special tokens added) also "offset_mapping"."""
        if return_offsets_mapping:
            if not isinstance(texts, str) or not add_special_tokens:
                raise NotImplementedError(
                    "offsets of one text or pair, with special tokens")
            ids, types, offsets = self.encode_offsets(
                texts, text_pair, truncation, max_length)
            return {"input_ids": ids, "token_type_ids": types,
                    "offset_mapping": offsets}
        if isinstance(texts, str):
            ids, types = self.encode_plus(texts, text_pair,
                                          add_special_tokens, truncation,
                                          max_length)
            return {"input_ids": ids, "token_type_ids": types}
        pairs = text_pair if text_pair is not None else [None] * len(texts)
        out = [self.encode_plus(t, p, add_special_tokens, truncation,
                                max_length) for t, p in zip(texts, pairs)]
        return {"input_ids": [o[0] for o in out],
                "token_type_ids": [o[1] for o in out]}

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
        elif self._decode_chain is not None:
            text = "".join(self._decode_chain(toks))
        elif self.decoder["type"] == "Metaspace":
            rep = self.decoder.get("replacement", "\u2581")
            scheme = self.decoder.get("prepend_scheme", "always")
            text = "".join(
                tok.replace(rep, "" if n == 0 and scheme != "never" else " ")
                for n, tok in enumerate(toks))
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

        def strftime_now(fmt):  # Llama-3.2's template dates its prompt
            return datetime.now().strftime(fmt)

        def tojson(x, ensure_ascii=False, indent=None, separators=None,
                   sort_keys=False):
            return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                              separators=separators, sort_keys=sort_keys)

        env = ImmutableSandboxedEnvironment(
            trim_blocks=True, lstrip_blocks=True, extensions=[loopcontrols])
        env.filters["tojson"] = tojson
        env.globals["raise_exception"] = raise_exception
        env.globals["strftime_now"] = strftime_now
        text = env.from_string(self.chat_template).render(
            messages=messages, tools=None, documents=None,
            add_generation_prompt=add_generation_prompt,
            **self.special_tokens)
        if tokenize:
            return self.encode(text, add_special_tokens=add_special_tokens)
        return text


def gguf_merges(tokens: list[str], scores: list[float]) -> list[tuple]:
    """The merges transformers' ``GGUFTokenizerSkeleton`` builds for a GGUF
    vocabulary without them: every split of every token whose two halves
    are tokens, sorted within the token by the halves' scores and then,
    stably, by the token's score, highest first.  Membership is a set here
    (transformers tests ``in`` on the list); the order is the same."""
    vocab = {t: scores[i] for i, t in enumerate(tokens)}
    known = set(tokens)
    merges = []
    for merge, score in vocab.items():
        local = [(merge[:i], merge[i:], score) for i in range(1, len(merge))
                 if merge[:i] in known and merge[i:] in known]
        local.sort(key=lambda x: (vocab[x[0]], vocab[x[1]]), reverse=True)
        merges.extend(local)
    merges.sort(key=lambda m: m[2], reverse=True)
    return [(a, b) for a, b, _ in merges]


def _clean_up(text: str) -> str:
    """transformers' ``clean_up_tokenization``."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def train_byte_level_bpe(texts: Iterable[str], n_merges: int,
                         split_pattern: str = LLAMA3_SPLIT
                         ) -> tuple[dict[str, int], list[str]]:
    """(vocab, merges) of a byte-level BPE learnt from ``texts``: the 256
    byte characters (ids 0..255 in byte order), then up to ``n_merges``
    merges, each of the most frequent adjacent pair of the words that
    ``split_pattern`` cuts (ties to the smallest pair)."""
    rx = split_regex(split_pattern)
    counts = collections.Counter(
        _to_byte_level(piece) for text in texts
        for piece in _split_isolated(rx, text))
    vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    return vocab, _train_merges(counts, vocab, n_merges)


def train_sentencepiece_bpe(texts: Iterable[str], n_merges: int,
                            first_id: int
                            ) -> tuple[dict[str, int], list[str]]:
    """(vocab, merges) of a sentencepiece-style BPE (Llama-2's, Gemma's)
    learnt from ``texts``: the words as sentencepiece cuts them (``▁``
    before each space-separated word), their characters from id
    ``first_id`` on in order of first use, then up to ``n_merges`` merges
    as ``train_byte_level_bpe`` makes them."""
    counts = collections.Counter(
        "\u2581" + w for text in texts for w in text.split())
    vocab: dict[str, int] = {}
    for w in counts:
        for c in w:
            vocab.setdefault(c, first_id + len(vocab))
    return vocab, _train_merges(counts, vocab, n_merges, first_id)


def _train_merges(counts: collections.Counter, vocab: dict[str, int],
                  n_merges: int, first_id: int = 0) -> list[str]:
    """Up to ``n_merges`` merges of the words ``counts`` (word -> count),
    each of the most frequent adjacent pair (ties to the smallest pair),
    adding each merged token to ``vocab`` (ids from ``first_id`` on)."""
    words = [list(w) for w in counts]
    freq = list(counts.values())
    pairs: collections.Counter = collections.Counter()
    where: dict[tuple, set] = collections.defaultdict(set)

    def account(wi, sign):
        w = words[wi]
        for pair in zip(w, w[1:]):
            pairs[pair] += sign * freq[wi]
            if sign > 0:
                where[pair].add(wi)

    for wi in range(len(words)):
        account(wi, 1)
    heap = [(-n, pair) for pair, n in pairs.items()]
    heapq.heapify(heap)
    merges: list[str] = []
    while heap and len(merges) < n_merges:
        n, pair = heapq.heappop(heap)
        if pairs.get(pair, 0) != -n or n == 0:
            continue  # stale
        a, b = pair
        merged = a + b
        merges.append(f"{a} {b}")
        vocab.setdefault(merged, first_id + len(vocab))
        touched = set()
        for wi in where.pop(pair):
            w = words[wi]
            if not any(x == a and y == b for x, y in zip(w, w[1:])):
                continue
            account(wi, -1)
            touched.update(zip(w, w[1:]))
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            words[wi] = out
            account(wi, 1)
            touched.update(zip(out, out[1:]))
        del pairs[pair]
        for p in touched:
            if pairs[p] > 0:
                heapq.heappush(heap, (-pairs[p], p))
    return merges


def _byte_level_bpe_spec(vocab: dict[str, int], merges: list[str],
                         added: dict[str, int], *, split_pattern: str,
                         nfc: bool, ignore_merges: bool,
                         template: tuple[str, str | None] | None,
                         digits: bool = False) -> dict:
    """A ``tokenizer.json`` in the layout of Llama-3's (``template`` =
    (bos, None): a Sequence of the ByteLevel and TemplateProcessing
    post-processors, as Llama-3.1's), Qwen2's (NFC, the ByteLevel
    post-processor) or, with ``digits``, Command-R's (NFC, the Digits and
    ByteLevel pre-tokenizers, a TemplateProcessing post-processor)."""
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": False, "use_regex": False}
    post = byte_level
    if template is not None:
        post = _template_spec(template, added)
        if not digits:
            post = {"type": "Sequence", "processors": [
                dict(byte_level, add_prefix_space=True, use_regex=True),
                post]}
    if digits:  # Command-R's: each digit alone, then GPT-2's split
        pre = [{"type": "Digits", "individual_digits": True},
               dict(byte_level, trim_offsets=True, use_regex=True)]
    else:
        pre = [{"type": "Split", "pattern": {"Regex": split_pattern},
                "behavior": "Isolated", "invert": False}, byte_level]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": _added_spec(added),
        "normalizer": {"type": "NFC"} if nfc else None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": pre},
        "post_processor": post,
        "decoder": dict(byte_level),
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": ignore_merges,
                  "vocab": vocab, "merges": merges},
    }


def _added_spec(added: dict[str, int]) -> list[dict]:
    return [{"id": i, "content": t, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for t, i in sorted(added.items(), key=lambda kv: kv[1])]


def _template_spec(template: tuple[str, str | None],
                   added: dict[str, int]) -> dict:
    """TemplateProcessing ``first $A [last]`` / ``first $A [last] first:1
    $B:1 [last:1]``."""
    first, last = template
    a = [{"SpecialToken": {"id": first, "type_id": 0}},
         {"Sequence": {"id": "A", "type_id": 0}}]
    b = [{"SpecialToken": {"id": first, "type_id": 1}},
         {"Sequence": {"id": "B", "type_id": 1}}]
    if last is not None:
        a.append({"SpecialToken": {"id": last, "type_id": 0}})
        b.append({"SpecialToken": {"id": last, "type_id": 1}})
    return {"type": "TemplateProcessing", "single": a, "pair": a + b,
            "special_tokens": {t: {"id": t, "ids": [added[t]], "tokens": [t]}
                               for t in (first, last) if t is not None}}


def _sentencepiece_bpe_spec(vocab: dict[str, int], merges: list[str],
                            added: dict[str, int], *, layout: str,
                            template: tuple[str, str | None] | None) -> dict:
    """A ``tokenizer.json`` in the layout transformers' converters give a
    sentencepiece BPE (``convert_slow_tokenizer.py``): Gemma's (``layout``
    "gemma": spaces replaced by ``▁``, a Split on the string " " merged
    with the previous piece, unk ``<unk>``) or Llama-2's ("llama2", Phi-3's
    too: ``▁`` prepended, no pre-tokenizer, the decoder's Strip of the
    leading space); both BPE with ``byte_fallback`` and ``fuse_unk``."""
    replace = {"type": "Replace", "pattern": {"String": " "},
               "content": "\u2581"}
    decoders = [{"type": "Replace", "pattern": {"String": "\u2581"},
                 "content": " "}, {"type": "ByteFallback"}, {"type": "Fuse"}]
    if layout == "gemma":
        norm = replace
        pre = {"type": "Split", "pattern": {"String": " "},
               "behavior": "MergedWithPrevious", "invert": False}
    elif layout == "llama2":
        norm = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "\u2581"}, replace]}
        pre = None
        decoders.append({"type": "Strip", "content": " ", "start": 1,
                         "stop": 0})
    else:
        raise ValueError(f"sentencepiece BPE layout {layout!r}")
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": _added_spec(added),
        "normalizer": norm, "pre_tokenizer": pre,
        "post_processor": None if template is None else _template_spec(
            template, added),
        "decoder": {"type": "Sequence", "decoders": decoders},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }


def _word_spec(model: str, vocab: dict[str, int], specials: dict[str, str],
               lowercase: bool, strip_accents: bool,
               template: tuple[str, str] | None,
               scores: dict[str, float] | None) -> dict:
    """``write_tokenizer``'s WordPiece, WordLevel and Unigram files."""
    norms = ([{"type": "Lowercase"}] if lowercase else []) + (
        [{"type": "StripAccents"}] if strip_accents else [])
    special_set = set(specials.values())
    pre = {"type": "Sequence", "pretokenizers": [
        {"type": "Whitespace"},
        {"type": "Punctuation", "behavior": "Removed"}]}
    decoder = None
    if model == "WordPiece":
        mspec = {"type": "WordPiece", "unk_token": specials["unk_token"],
                 "continuing_subword_prefix": "##",
                 "max_input_chars_per_word": 100, "vocab": vocab}
    elif model == "WordLevel":
        mspec = {"type": "WordLevel", "vocab": vocab,
                 "unk_token": specials["unk_token"]}
    else:
        scores = scores or {}
        pieces = sorted(vocab, key=vocab.get)
        assert [vocab[t] for t in pieces] == list(range(len(pieces)))
        mspec = {"type": "Unigram", "unk_id": vocab[specials["unk_token"]],
                 "vocab": [[t, float(scores.get(t, 0.0))] for t in pieces],
                 "byte_fallback": False}
        norms += [{"type": "Strip", "strip_left": True, "strip_right": True},
                  {"type": "Replace", "pattern": {"Regex": " {2,}"},
                   "content": " "}]
        meta = {"type": "Metaspace", "replacement": "\u2581",
                "prepend_scheme": "always", "split": True}
        pre, decoder = meta, dict(meta)
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": vocab[t], "content": t, "single_word": False,
             "lstrip": False, "rstrip": False, "normalized": False,
             "special": True}
            for t in sorted(special_set, key=lambda t: vocab[t])],
        "normalizer": {"type": "Sequence", "normalizers": norms},
        "pre_tokenizer": pre,
        "post_processor": None,
        "decoder": decoder,
        "model": mspec,
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
    return spec


def write_tokenizer(path: str, model: str, vocab: dict[str, int],
                    specials: dict[str, str], *, lowercase: bool = True,
                    strip_accents: bool = False,
                    template: tuple[str, str | None] | None = None,
                    chat_template: str | None = None,
                    scores: dict[str, float] | None = None,
                    merges: list[str] | None = None,
                    added: dict[str, int] | None = None,
                    split_pattern: str = LLAMA3_SPLIT, nfc: bool = False,
                    ignore_merges: bool = False,
                    clean_up_spaces: bool = False, digits: bool = False,
                    layout: str = "gemma") -> None:
    """Write ``tokenizer.json`` + ``tokenizer_config.json`` in HF's format.

    model: "WordPiece", "WordLevel", "Unigram", "ByteLevelBPE" or
    "SentencePieceBPE" (``layout`` "gemma" or "llama2",
    ``_sentencepiece_bpe_spec``; vocab, ``merges`` and special ``added``
    tokens as for ByteLevelBPE); vocab:
    token -> id (special tokens included, but for ByteLevelBPE, whose
    special tokens are ``added``; for Unigram the ids are 0..n-1 and each
    piece scores ``scores[piece]``, 0 by default); specials: e.g.
    {"pad_token": "[PAD]", "unk_token": ...}; template: (first, last)
    special tokens of a ``first $A last`` / ``first $A last $B:1 last:1``
    TemplateProcessing post-processor (``last`` None: ``first $A`` /
    ``first $A first:1 $B:1``).  A Unigram tokenizer is written as
    DeBERTa-v3's is (Strip and space-collapsing normalizers, Metaspace
    pre-tokenizer and decoder), without its ``Precompiled`` charsmap.  A
    ByteLevelBPE one (``merges``, ``added`` special tokens, the Split
    ``split_pattern``, an NFC normalizer with ``nfc``, ``ignore_merges``)
    is written as Llama-3's is with a template and as Qwen2's is without,
    and with ``digits`` as Command-R's (``_byte_level_bpe_spec``)."""
    os.makedirs(path, exist_ok=True)
    if model == "ByteLevelBPE":
        spec = _byte_level_bpe_spec(
            vocab, merges or [], added or {}, split_pattern=split_pattern,
            nfc=nfc, ignore_merges=ignore_merges, template=template,
            digits=digits)
    elif model == "SentencePieceBPE":
        spec = _sentencepiece_bpe_spec(vocab, merges or [], added or {},
                                       layout=layout, template=template)
    else:
        spec = _word_spec(model, vocab, specials, lowercase, strip_accents,
                          template, scores)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    config = {"clean_up_tokenization_spaces": clean_up_spaces,
              "tokenizer_class": "PreTrainedTokenizerFast", **specials}
    if chat_template is not None:
        config["chat_template"] = chat_template
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f, indent=2)
