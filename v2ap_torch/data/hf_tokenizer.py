"""Hugging Face tokenizers read from their files, in pure Python and numpy.

The JAX package tokenizes a prompt with ``transformers.AutoTokenizer``
(FLAN-T5's sentencepiece Unigram in ``pipelines/generate.py``, CLAP's
RoBERTa byte-level BPE in ``evaluation/clap_scorer.py``); the port reads the
same directory itself (the card's machine has neither ``transformers`` nor
``tokenizers``) and gives the same ids. It reads ``tokenizer.json``,
``tokenizer_config.json`` and ``special_tokens_map.json`` where present and
runs what the ``tokenizers`` crate runs for one sequence:

  added tokens  split out of the raw text (those marked ``normalized``: out
                of each normalized piece), leftmost-longest, with
                ``single_word``, ``lstrip`` and ``rstrip``; the special
                tokens the configs name count as added ones
  normalizer    ``Sequence``; ``Precompiled`` (sentencepiece's charsmap: a
                u32 trie size, a darts-clone double array, the NUL-ended
                replacements; per extended grapheme cluster under 6 bytes
                the *first*, shortest, key that prefixes it replaces the
                whole cluster, else code point by code point, as the crate
                does); ``Replace`` (a string or a regex); ``Strip``
  pre-tokenizer ``Sequence``; ``WhitespaceSplit``; ``Metaspace`` (``▁``,
                ``prepend_scheme`` or the older ``add_prefix_space``,
                ``split``); ``ByteLevel`` (GPT-2's split pattern, its
                ``\\p{L}`` and ``\\p{N}`` through ``unicodedata``, the
                bytes-to-unicode map, ``add_prefix_space``)
  model         ``Unigram`` (Viterbi over the piece scores in float64,
                unknown code points at the lowest score less 10, unknown
                runs fused, ``byte_fallback``); ``BPE`` (merges by rank,
                leftmost first, ``unk_token`` with ``fuse_unk``,
                ``continuing_subword_prefix``, ``end_of_word_suffix``,
                ``byte_fallback``, ``ignore_merges``)
  post-process  ``TemplateProcessing``, ``RobertaProcessing``

Any other component type raises ``NotImplementedError`` naming it, rather
than give other ids. A batch is called as the JAX package calls
``transformers``: truncated to ``max_length`` less the special tokens the
post-processor adds (right side), right-padded with the pad token's id to
the longest row, int32 ids and attention masks.
"""

from __future__ import annotations

import bisect
import functools
import heapq
import json
import re
import struct
import unicodedata
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# transformers' model_max_length when the config has none
VERY_LARGE_INTEGER = int(1e30)
CLAP_MAX_LENGTH = 64           # the JAX package's make_clap_scorer


class _Piece:
    """A run of text on its way through the pipeline: its characters, each
    one's offset in the original text, and the original offset it starts
    at (``offsets_original().0`` of the crate's NormalizedString, which
    Metaspace's ``first`` scheme reads)."""

    __slots__ = ("text", "orig", "shift")

    def __init__(self, text: str, orig: List[int], shift: int):
        self.text, self.orig, self.shift = text, orig, shift

    def sub(self, i: int, j: int) -> "_Piece":
        """Characters i..j as a piece of their own (the crate's slice)."""
        return _Piece(self.text[i:j], self.orig[i:j],
                      self.orig[i] if i else self.shift)


# ------------------------------------------------------------ characters

def _is_whitespace(c: str) -> bool:
    """Rust's ``char::is_whitespace`` (Unicode White_Space): Python's
    ``isspace`` less the four information separators."""
    return c.isspace() and c not in "\x1c\x1d\x1e\x1f"


def _is_regex_space(c: str) -> bool:
    """Oniguruma's ``\\s`` on Unicode text: \\t-\\r, U+0085 and the
    separators (Zs, Zl, Zp)."""
    return c in "\t\n\x0b\x0c\r\x85" or unicodedata.category(c) in (
        "Zs", "Zl", "Zp")


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Tuple[str, ...]:
    """GPT-2's reversible byte -> printable character map."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return tuple(table[b] for b in range(256))


# ------------------------------------------- extended grapheme clusters

# Grapheme_Cluster_Break values that General_Category does not give
# (UAX #29): Prepend, the Extend characters outside Mn / Me, Spacing marks
# outside Mc and the Mc characters that are not Spacing marks, the default
# ignorable unassigned ranges (Control), and Extended_Pictographic.
_PREPEND = ((0x0600, 0x0605), (0x06DD, 0x06DD), (0x070F, 0x070F),
            (0x0890, 0x0891), (0x08E2, 0x08E2), (0x0D4E, 0x0D4E),
            (0x110BD, 0x110BD), (0x110CD, 0x110CD), (0x111C2, 0x111C3),
            (0x1193F, 0x1193F), (0x11941, 0x11941), (0x11A3A, 0x11A3A),
            (0x11A84, 0x11A89), (0x11D46, 0x11D46), (0x11F02, 0x11F02))
_EXTEND = ((0x200C, 0x200C), (0xFF9E, 0xFF9F), (0x1F3FB, 0x1F3FF),
           (0xE0020, 0xE007F))
_SPACING = ((0x0E33, 0x0E33), (0x0EB3, 0x0EB3))
_MC_OTHER = ((0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064),
             (0x1067, 0x106D), (0x1083, 0x1083), (0x1087, 0x108C),
             (0x108F, 0x108F), (0x109A, 0x109C), (0x1A61, 0x1A61),
             (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
             (0x11720, 0x11721))
_IGNORABLE = ((0x2065, 0x2065), (0xFFF0, 0xFFF8), (0xE0000, 0xE0000),
              (0xE0002, 0xE001F), (0xE0080, 0xE00FF), (0xE01F0, 0xE0FFF))
_PICTOGRAPHIC = (
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049),
    (0x2122, 0x2122), (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA),
    (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB),
    (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721),
    (0x2728, 0x2728), (0x2733, 0x2734), (0x2744, 0x2744), (0x2747, 0x2747),
    (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C),
    (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
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


def _in(ranges, cp: int) -> bool:
    i = bisect.bisect_right(ranges, (cp, 0x10FFFF)) - 1
    return i >= 0 and ranges[i][0] <= cp <= ranges[i][1]


@functools.lru_cache(maxsize=4096)
def _gcb(c: str) -> str:
    """The Grapheme_Cluster_Break class of a code point."""
    cp = ord(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    if _in(_PREPEND, cp):
        return "Prepend"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me") or _in(_EXTEND, cp):
        return "Extend"
    if cat in ("Cc", "Cf", "Zl", "Zp", "Cs") or _in(_IGNORABLE, cp):
        return "Control"
    if (cat == "Mc" and not _in(_MC_OTHER, cp)) or _in(_SPACING, cp):
        return "SpacingMark"
    if _in(_PICTOGRAPHIC, cp):
        return "ExtPict"
    return "Other"


def graphemes(text: str) -> List[Tuple[int, int]]:
    """Extended grapheme clusters (UAX #29 rules GB3-GB13) as character
    index ranges."""
    out: List[Tuple[int, int]] = []
    if not text:
        return out
    start, prev = 0, _gcb(text[0])
    ri = int(prev == "RI")          # regional indicators in a row
    emoji = prev == "ExtPict"       # ExtPict Extend* (ZWJ) so far
    for i in range(1, len(text)):
        cur = _gcb(text[i])
        if prev == "CR" and cur == "LF":
            join = True
        elif prev in ("Control", "CR", "LF") or cur in ("Control", "CR",
                                                        "LF"):
            join = False
        elif prev == "L" and cur in ("L", "V", "LV", "LVT"):
            join = True
        elif prev in ("LV", "V") and cur in ("V", "T"):
            join = True
        elif prev in ("LVT", "T") and cur == "T":
            join = True
        elif cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            join = True
        elif prev == "ZWJ" and cur == "ExtPict" and emoji:
            join = True
        elif prev == "RI" and cur == "RI":
            join = ri % 2 == 1
        else:
            join = False
        if not join:
            out.append((start, i))
            start = i
        ri = ri + 1 if cur == "RI" else 0
        if cur == "ExtPict":
            emoji = True
        elif not (emoji and cur in ("Extend", "ZWJ") and prev != "ZWJ"):
            emoji = False
        prev = cur
    out.append((start, len(text)))
    return out


# ------------------------------------------------------------ normalizers

Normalizer = Callable[[str, List[int]], Tuple[str, List[int]]]


class _Charsmap:
    """sentencepiece's precompiled charsmap, read as the crate reads it."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob)
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.strings = blob[4 + size:]

    def transform(self, chunk: str) -> Optional[str]:
        """The replacement of the first (shortest) key that prefixes
        ``chunk``, or None."""
        units = self.units

        def offset(u):
            return (u >> 10) << ((u & (1 << 9)) >> 6)

        pos = offset(units[0])
        for byte in chunk.encode():
            if byte == 0:
                break
            pos ^= byte
            if pos >= len(units) or units[pos] & ((1 << 31) | 0xFF) != byte:
                return None
            unit = units[pos]
            pos ^= offset(unit)
            if unit >> 8 & 1:
                value = units[pos] & ((1 << 31) - 1)
                end = self.strings.index(b"\0", value)
                return self.strings[value:end].decode()
        return None

    def __call__(self, text: str, orig: List[int]):
        out, aligned = [], []

        def put(s: str, at: int):
            out.append(s)
            aligned.extend([at] * len(s))

        for i, j in graphemes(text):
            cluster = text[i:j]
            if len(cluster.encode()) < 6:
                norm = self.transform(cluster)
                if norm is not None:
                    put(norm, orig[i])
                    continue
            for k in range(i, j):
                norm = self.transform(text[k])
                put(text[k] if norm is None else norm, orig[k])
        return "".join(out), aligned


def _compile(pattern: dict, where: str) -> "re.Pattern":
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern for Python's ``re``;
    a regex it reads differently from Oniguruma's (\\p classes) raises."""
    if "String" in pattern:
        return re.compile(re.escape(pattern["String"]))
    try:
        return re.compile(pattern["Regex"])
    except re.error as exc:
        raise NotImplementedError(f"{where} regex {pattern['Regex']!r}: "
                                  f"{exc}") from exc


def _replace(spec: dict) -> Normalizer:
    regex, content = _compile(spec["pattern"], "Replace"), spec["content"]

    def run(text, orig):
        out, aligned, last = [], [], 0
        for m in regex.finditer(text):
            if m.start() == m.end():
                continue
            out.append(text[last:m.start()])
            aligned.extend(orig[last:m.start()])
            out.append(content)
            aligned.extend([orig[m.start()]] * len(content))
            last = m.end()
        out.append(text[last:])
        aligned.extend(orig[last:])
        return "".join(out), aligned
    return run


def _strip(spec: dict) -> Normalizer:
    left, right = spec.get("strip_left", True), spec.get("strip_right", True)

    def run(text, orig):
        i, j = 0, len(text)
        while left and i < j and _is_whitespace(text[i]):
            i += 1
        while right and j > i and _is_whitespace(text[j - 1]):
            j -= 1
        return text[i:j], orig[i:j]
    return run


def _normalizer(spec: Optional[dict]) -> Optional[Normalizer]:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def run(text, orig):
            for part in parts:
                text, orig = part(text, orig)
            return text, orig
        return run
    if kind == "Precompiled":
        import base64
        blob = spec["precompiled_charsmap"]
        return _Charsmap(base64.b64decode(blob) if isinstance(blob, str)
                         else bytes(blob))
    if kind == "Replace":
        return _replace(spec)
    if kind == "Strip":
        return _strip(spec)
    raise NotImplementedError(f"tokenizer.json normalizer type {kind!r}")


# --------------------------------------------------------- pre-tokenizers

PreTokenizer = Callable[[_Piece], List[_Piece]]


def _split(piece: _Piece, spans: List[Tuple[int, int]],
           behavior: str) -> List[_Piece]:
    """The crate's ``NormalizedString::split``: ``spans`` are the
    delimiter matches; empty pieces are dropped."""
    segments, last = [], 0            # (start, end, is_match), tiling
    for i, j in spans:
        if last < i:
            segments.append((last, i, False))
        segments.append((i, j, True))
        last = j
    if last < len(piece.text):
        segments.append((last, len(piece.text), False))
    if behavior == "removed":
        keep = [(i, j) for i, j, m in segments if not m]
    elif behavior == "isolated":
        keep = [(i, j) for i, j, _ in segments]
    else:                               # merged with the next piece
        keep, following = [], False
        for i, j, m in reversed(segments):
            if m and not following and keep:
                keep[-1] = (i, keep[-1][1])
            else:
                keep.append((i, j))
            following = m
        keep.reverse()
    return [piece.sub(i, j) for i, j in keep if i < j]


def _whitespace_split(piece: _Piece) -> List[_Piece]:
    spans = [(i, i + 1) for i, c in enumerate(piece.text)
             if _is_whitespace(c)]
    return _split(piece, spans, "removed")


def _metaspace(spec: dict) -> PreTokenizer:
    repl = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme")
    if scheme is None:                 # the older serialization
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in ("always", "first", "never"):
        raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r}")
    split = spec.get("split", True)

    def run(piece):
        text = piece.text.replace(" ", repl)
        orig = piece.orig
        if (scheme == "always" or (scheme == "first" and piece.shift == 0)) \
                and not text.startswith(repl):
            text = repl + text
            orig = [piece.shift] + orig
        piece = _Piece(text, orig, piece.shift)
        if not split:
            return [piece]
        spans = [(i, i + 1) for i, c in enumerate(text) if c == repl]
        return _split(piece, spans, "merged_with_next")
    return run


def gpt2_split(text: str) -> List[Tuple[int, int]]:
    """GPT-2's pre-tokenizer pattern, ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+|
    ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, as Oniguruma matches it:
    the (start, end) spans it finds, which tile ``text``."""
    def other(c):
        return not (_is_regex_space(c) or _is_letter(c) or _is_number(c))

    n, i, out = len(text), 0, []
    while i < n:
        c, j = text[i], None
        if c == "'" and text[i + 1:i + 2] in ("s", "t", "m", "d"):
            j = i + 2
        elif c == "'" and text[i + 1:i + 3] in ("re", "ve", "ll"):
            j = i + 3
        else:
            # a class run, after one optional literal space
            k = i + 1 if c == " " else i
            for pred in (_is_letter, _is_number, other):
                if k < n and pred(text[k]):
                    j = k + 1
                    while j < n and pred(text[j]):
                        j += 1
                    break
        if j is None:
            # whitespace: the run less its last character when a
            # non-space follows it (\s+(?!\S)), else the whole run
            e = i + 1
            while e < n and _is_regex_space(text[e]):
                e += 1
            j = e if e == n or e - i == 1 else e - 1
        out.append((i, j))
        i = j
    return out


def _byte_level(spec: dict) -> PreTokenizer:
    prefix = spec.get("add_prefix_space", True)
    use_regex = spec.get("use_regex", True)
    table = _bytes_to_unicode()

    def run(piece):
        if prefix and not piece.text.startswith(" "):
            piece = _Piece(" " + piece.text, [piece.shift] + piece.orig,
                           piece.shift)
        parts = (_split(piece, gpt2_split(piece.text), "isolated")
                 if use_regex else [piece])
        for part in parts:
            chars, orig = [], []
            for c, o in zip(part.text, part.orig):
                mapped = [table[b] for b in c.encode()]
                chars.extend(mapped)
                orig.extend([o] * len(mapped))
            part.text, part.orig = "".join(chars), orig
        return parts
    return run


def _pre_tokenizer(spec: Optional[dict]) -> Optional[PreTokenizer]:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(piece):
            pieces = [piece]
            for part in parts:
                pieces = [q for p in pieces for q in part(p)]
            return pieces
        return run
    if kind == "WhitespaceSplit":
        return _whitespace_split
    if kind == "Metaspace":
        return _metaspace(spec)
    if kind == "ByteLevel":
        return _byte_level(spec)
    raise NotImplementedError(f"tokenizer.json pre_tokenizer type {kind!r}")


# ----------------------------------------------------------------- models

class _Unigram:
    """The crate's Unigram: Viterbi over piece scores (float64), ties to
    the shorter piece ending at a position, an unknown code point at the
    lowest score less 10, consecutive unknowns fused."""

    def __init__(self, spec: dict):
        self.vocab = {piece: i for i, (piece, _) in enumerate(spec["vocab"])}
        self.scores = [float(score) for _, score in spec["vocab"]]
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = spec.get("byte_fallback", False)
        self.max_len = max((len(p) for p in self.vocab), default=1)
        self.unk_score = min(self.scores, default=0.0) - 10.0

    def __call__(self, text: str) -> List[int]:
        n = len(text)
        best = [(-np.inf, -1, -1)] * (n + 1)       # (score, start, id)
        best[0] = (0.0, 0, -1)
        for i in range(n):
            here = best[i][0]
            single = False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                tid = self.vocab.get(text[i:j])
                if tid is None:
                    continue
                score = self.scores[tid] + here
                if best[j][1] < 0 or score > best[j][0]:
                    best[j] = (score, i, tid)
                if j == i + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram: an unknown piece and no unk_id")
                score = self.unk_score + here
                if best[i + 1][1] < 0 or score > best[i + 1][0]:
                    best[i + 1] = (score, i, self.unk_id)
        pieces, end, unk = [], n, []
        while end > 0:
            _, start, tid = best[end]
            if tid == self.unk_id:
                unk.append(text[start:end])
            else:
                if unk:
                    pieces.append("".join(reversed(unk)))
                    unk = []
                pieces.append(text[start:end])
            end = start
        if unk:
            pieces.append("".join(reversed(unk)))
        ids = []
        for piece in reversed(pieces):
            tid = self.vocab.get(piece)
            if tid is None and self.byte_fallback:
                fall = [self.vocab.get(f"<0x{b:02X}>") for b in piece.encode()]
                if None not in fall:
                    ids.extend(fall)
                    continue
            if tid is None:
                if self.unk_id is None:
                    raise ValueError("Unigram: an unknown piece and no unk_id")
                tid = self.unk_id
            ids.append(tid)
        return ids


class _BPE:
    """The crate's BPE: the word's characters (with the continuing-subword
    prefix and end-of-word suffix), unknown ones as ``unk_token`` (fused
    when ``fuse_unk``) or their ``<0xXX>`` bytes, then merges by rank,
    leftmost first."""

    def __init__(self, spec: dict):
        if spec.get("dropout") not in (None, 0.0):
            raise NotImplementedError("BPE dropout")
        self.vocab = dict(spec["vocab"])
        self.unk = spec.get("unk_token")
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.fuse_unk = spec.get("fuse_unk", False)
        self.byte_fallback = spec.get("byte_fallback", False)
        self.ignore_merges = spec.get("ignore_merges", False)
        self.merges = {}
        for rank, merge in enumerate(spec["merges"]):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            new = self.vocab[a + b[len(self.prefix):]]
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, new)

    def _word(self, text: str) -> List[int]:
        symbols, unk = [], None
        for i, c in enumerate(text):
            s = (self.prefix if i else "") + c + (
                self.suffix if i == len(text) - 1 else "")
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    symbols.append(unk)
                    unk = None
                symbols.append(tid)
                continue
            if self.byte_fallback:
                fall = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode()]
                if None not in fall:
                    symbols.extend(fall)
                    continue
            if self.unk is not None:
                unk_id = self.vocab[self.unk]
                if unk is not None and not self.fuse_unk:
                    symbols.append(unk)
                unk = unk_id
        if unk is not None:
            symbols.append(unk)
        return symbols

    def __call__(self, text: str) -> List[int]:
        if not text:
            return []
        if self.ignore_merges and text in self.vocab:
            return [self.vocab[text]]
        sym = self._word(text)
        n = len(sym)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = self.merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new:
                continue
            sym[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = self.merges.get((sym[prev[pos]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] < n:
                m = self.merges.get((new, sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]


def _model(spec: dict):
    kind = spec.get("type")
    if kind == "Unigram":
        return _Unigram(spec)
    if kind == "BPE":
        return _BPE(spec)
    raise NotImplementedError(f"tokenizer.json model type {kind!r}")


# --------------------------------------------------------- post-processing

def _post_processor(spec: Optional[dict]) -> Tuple[List, int]:
    """-> (the single-sequence template: ids and None for the sequence, the
    number of ids it adds)."""
    if spec is None:
        return [None], 0
    kind = spec["type"]
    if kind == "RobertaProcessing":
        template = [spec["cls"][1], None, spec["sep"][1]]
    elif kind == "TemplateProcessing":
        template = []
        for item in spec["single"]:
            if "Sequence" in item:
                if item["Sequence"]["id"] != "A":
                    raise NotImplementedError("TemplateProcessing: a single "
                                              "template reading $B")
                template.append(None)
            else:
                name = item["SpecialToken"]["id"]
                template.extend(spec["special_tokens"][name]["ids"])
    else:
        raise NotImplementedError(
            f"tokenizer.json post_processor type {kind!r}")
    return template, sum(t is not None for t in template)


# ------------------------------------------------------------ added tokens

class _AddedToken:
    __slots__ = ("content", "id", "single_word", "lstrip", "rstrip",
                 "normalized")

    def __init__(self, content: str, tid: int, single_word=False,
                 lstrip=False, rstrip=False, normalized=False):
        self.content, self.id = content, tid
        self.single_word, self.lstrip, self.rstrip = single_word, lstrip, rstrip
        self.normalized = normalized


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


def _find_added(text: str, tokens: dict) -> List[Tuple[int, int, Optional[int]]]:
    """The crate's ``AddedVocabulary::find_matches``: leftmost-longest
    matches of ``tokens`` (match text -> _AddedToken) with their
    whitespace stripping and word rules, as tiling (start, end, id or
    None) spans."""
    if not tokens:
        return [(0, len(text), None)]
    lengths = sorted({len(k) for k in tokens}, reverse=True)
    out, done, i = [], 0, 0
    while i < len(text):
        hit = next((text[i:i + n] for n in lengths
                    if text[i:i + n] in tokens), None)
        if hit is None:
            i += 1
            continue
        tok = tokens[hit]
        start, stop = i, i + len(hit)
        i = stop
        if tok.single_word and (
                (start > 0 and _is_word_char(text[start - 1]))
                or (stop < len(text) and _is_word_char(text[stop]))):
            continue
        if tok.lstrip:
            k = start
            while k > 0 and _is_whitespace(text[k - 1]):
                k -= 1
            start = max(k, done)
        if tok.rstrip:
            while stop < len(text) and _is_whitespace(text[stop]):
                stop += 1
        if done < start:
            out.append((done, start, None))
        out.append((start, stop, tok.id))
        done = stop
    if done < len(text):
        out.append((done, len(text), None))
    return out


# --------------------------------------------------------------- tokenizer

def _special_contents(config: dict) -> List:
    """The special tokens a transformers config names (strings or
    AddedToken dicts), additional ones included."""
    out = []
    for key in ("bos_token", "eos_token", "unk_token", "sep_token",
                "pad_token", "cls_token", "mask_token"):
        if config.get(key) is not None:
            out.append(config[key])
    out.extend(config.get("additional_special_tokens") or [])
    return out


def _content(token) -> str:
    return token["content"] if isinstance(token, dict) else token


class HFTokenizer:
    """A tokenizer directory (``tokenizer.json``, and the transformers
    configs where present) as the ``tokenizers`` crate runs it."""

    def __init__(self, path):
        path = Path(path)
        spec = json.loads((path / "tokenizer.json").read_text("utf-8"))
        config = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            if (path / name).exists():
                config.update(json.loads((path / name).read_text("utf-8")))
        for side in ("padding_side", "truncation_side"):
            if config.get(side, "right") != "right":
                raise NotImplementedError(f"{side} {config[side]!r}")
        if spec.get("truncation") or spec.get("padding"):
            raise NotImplementedError("tokenizer.json with its own truncation "
                                      "or padding")
        self.normalizer = _normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _pre_tokenizer(spec.get("pre_tokenizer"))
        model = spec["model"]
        self.model = _model(model)
        self.template, self.n_added = _post_processor(
            spec.get("post_processor"))
        added = [_AddedToken(t["content"], t["id"], t.get("single_word", False),
                             t.get("lstrip", False), t.get("rstrip", False),
                             t.get("normalized", False))
                 for t in spec.get("added_tokens") or []]
        # the configs' special tokens that tokenizer.json lacks, added as
        # transformers adds them (special, not normalized; a new id after
        # the last when the vocabulary lacks them too)
        vocab = dict(self.model.vocab)
        vocab.update({t.content: t.id for t in added})
        for token in _special_contents(config):
            content = _content(token)
            if any(t.content == content for t in added):
                continue
            tid = vocab.get(content)
            if tid is None:
                tid = max(vocab.values(), default=-1) + 1
                vocab[content] = tid
            flags = token if isinstance(token, dict) else {}
            added.append(_AddedToken(content, tid,
                                     flags.get("single_word", False),
                                     flags.get("lstrip", False),
                                     flags.get("rstrip", False), False))
        self.vocab = vocab
        self.raw_tokens = {t.content: t for t in added if not t.normalized}
        self.norm_tokens = {}
        for t in added:
            if t.normalized:
                key = t.content
                if self.normalizer is not None:
                    key = self.normalizer(key, list(range(len(key))))[0]
                self.norm_tokens[key] = t
        self.model_max_length = int(config.get("model_max_length",
                                               VERY_LARGE_INTEGER))
        pad = config.get("pad_token")
        self.pad_id = None if pad is None else vocab.get(_content(pad))

    def tokens(self, text: str) -> List[int]:
        """The ids of ``text`` without the post-processor's tokens."""
        ids: List[int] = []
        for start, stop, tid in _find_added(text, self.raw_tokens):
            if tid is not None:
                ids.append(tid)
                continue
            piece = _Piece(text[start:stop], list(range(start, stop)), start)
            norm, orig = piece.text, piece.orig
            if self.normalizer is not None:
                norm, orig = self.normalizer(norm, orig)
            normalized = _Piece(norm, orig, start)
            for i, j, nid in _find_added(norm, self.norm_tokens):
                if nid is not None:
                    ids.append(nid)
                    continue
                if i == j:
                    continue
                sub = normalized.sub(i, j)
                words = (self.pre_tokenizer(sub) if self.pre_tokenizer
                         else [sub])
                for word in words:
                    ids.extend(self.model(word.text))
        return ids

    def encode(self, text: str, max_length: Optional[int] = None
               ) -> List[int]:
        """The ids of ``text`` with the post-processor's tokens, its own
        ones truncated to leave room for them within ``max_length``."""
        ids = self.tokens(text)
        if max_length is not None:
            ids = ids[:max(0, max_length - self.n_added)]
        out = []
        for t in self.template:
            if t is None:
                out.extend(ids)
            else:
                out.append(t)
        return out

    def __call__(self, texts: Sequence[str],
                 max_length: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """A batch as ``tok(texts, padding=True, truncation=True,
        max_length=max_length)``: int32 ids and attention masks, right-
        padded with the pad id to the longest row."""
        rows = [self.encode(t, max_length) for t in texts]
        if self.pad_id is None:
            raise ValueError("the tokenizer has no pad token to pad with")
        width = max((len(r) for r in rows), default=0)
        ids = np.full((len(rows), width), self.pad_id, np.int32)
        mask = np.zeros((len(rows), width), np.int32)
        for i, row in enumerate(rows):
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask


def load_t5(path) -> Callable:
    """prompts -> (ids, mask): the JAX pipeline's T5 call,
    ``max_length=model_max_length``."""
    tok = HFTokenizer(path)

    def encode(prompts):
        return tok(list(prompts), max_length=tok.model_max_length)
    encode.encode = tok.encode
    return encode


def load_clap(path) -> Callable:
    """captions -> (ids, mask): the JAX CLAP scorer's call,
    ``max_length=64``."""
    tok = HFTokenizer(path)

    def encode(captions):
        return tok(list(captions), max_length=CLAP_MAX_LENGTH)
    encode.encode = tok.encode
    return encode
