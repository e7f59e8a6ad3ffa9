"""Text tokenizers of the token (TTS-side) path.

Counterpart of ``v2ap_tpu/data/tokenizers.py``: UTF-8 bytes, English g2p
phonemes and the Chinese 1342-symbol pinyin scheme. Each returns
``(encode, vocab_size)``, ``encode(texts) -> (b, n) int32`` padded with -1.
The shipped configs condition the text stream on CLIP features and never
tokenize; the byte tokenizer is complete, the English phonemes need
``g2p_en`` (it raises without it), and the Chinese one segments raw text
with ``jieba`` + ``pypinyin`` when they are installed and otherwise takes
pre-segmented pinyin / ascii (``zh_tokens_to_ids``). The pinyin syllables
are this package's own copy, ``zh_pinyin_table.json``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Tuple

import numpy as np

PAD_ID = -1

ZH_PUNCS = ["，", "。", "？", "、"]
ZH_LETTERS = list("abcdefghijklmnopqrstuvwxyz") + ["'", " "]
ZH_UPPERS = list("ABCDEFGHIJKLMNOPQRSTUVWXYZ")
ZH_NUM_PHONEMES = 1342


def _pad_rows(rows: List[List[int]]) -> np.ndarray:
    n = max((len(r) for r in rows), default=1)
    out = np.full((len(rows), n), PAD_ID, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def byte_tokenizer() -> Tuple[Callable[[List[str]], np.ndarray], int]:
    """UTF-8 bytes, vocabulary 256."""

    def encode(texts: List[str]) -> np.ndarray:
        return _pad_rows([list(t.encode("utf-8")) for t in texts])

    return encode, 256


def phoneme_en_tokenizer() -> Tuple[Callable[[List[str]], np.ndarray], int]:
    """English g2p phonemes plus 8 punctuation symbols (needs ``g2p_en``)."""
    try:
        from g2p_en import G2p
    except ImportError as exc:
        raise ImportError(
            "phoneme_en tokenizer requires g2p_en; install it or use "
            "tokenizer='char_utf8'") from exc
    g2p = G2p()
    phoneme_to_index = dict(g2p.p2idx)
    extras = [" ", ",", ".", "-", "!", "?", "'", '"']
    for i, ch in enumerate(extras):
        phoneme_to_index[ch] = len(g2p.p2idx) + i

    def encode(texts: List[str]) -> np.ndarray:
        return _pad_rows([[phoneme_to_index[p] for p in g2p(t)
                           if p in phoneme_to_index] for t in texts])

    return encode, len(phoneme_to_index)


def zh_phoneme_table() -> dict:
    """Symbol -> id: the 4 CJK punctuation marks, the 1310 toned pinyin
    syllables of ``zh_pinyin_table.json``, then 28 ascii symbols. Upper-case
    letters share the lower-case ids, as the published checkpoints were
    trained with."""
    path = os.path.join(os.path.dirname(__file__), "zh_pinyin_table.json")
    with open(path) as f:
        pinyins = json.load(f)
    table = {p: i for i, p in enumerate(ZH_PUNCS)}
    base = len(ZH_PUNCS)
    table.update({p: base + i for i, p in enumerate(pinyins)})
    base += len(pinyins)
    table.update({ch: base + i for i, ch in enumerate(ZH_LETTERS)})
    table.update({ch: base + i for i, ch in enumerate(ZH_UPPERS)})
    if base + len(ZH_LETTERS) != ZH_NUM_PHONEMES:
        raise ValueError(f"zh table has {base + len(ZH_LETTERS)} symbols, "
                         f"not {ZH_NUM_PHONEMES}")
    return table


def zh_tokens_to_ids(tokens: List[str], table: dict) -> List[int]:
    """Pre-segmented symbols (pinyin syllables, letters, punctuation) ->
    ids; an ascii word not in the table goes per character."""
    out = []
    for tok in tokens:
        if tok in table:
            out.append(table[tok])
        elif all(c in table for c in tok):
            out.extend(table[c] for c in tok)
        else:
            raise KeyError(f"symbol {tok!r} not in the zh phoneme table")
    return out


def phoneme_zh_tokenizer() -> Tuple[Callable[[List[str]], np.ndarray], int]:
    """Chinese pinyin phonemes over the 1342-symbol table: raw text through
    ``jieba`` + ``pypinyin`` (TONE3, tone sandhi) when both are installed,
    else pre-segmented input through ``zh_tokens_to_ids``."""
    table = zh_phoneme_table()
    try:
        import jieba
        from pypinyin import Style, lazy_pinyin
        have_zh = True
    except ImportError:
        have_zh = False

    def tokenize(t: str) -> List[int]:
        if not have_zh:
            words = t.split(" ")
            return zh_tokens_to_ids(
                words if any(len(w) > 1 for w in words) else list(t), table)
        row: List[int] = []
        for word in jieba.cut(t):
            if all("一" <= c <= "鿿" for c in word):
                row.extend(table[s] for s in lazy_pinyin(
                    word, style=Style.TONE3, tone_sandhi=True) if s in table)
            else:
                row.extend(table[ch] for ch in word if ch in table)
        return row

    def encode(texts: List[str]) -> np.ndarray:
        return _pad_rows([tokenize(t) for t in texts])

    return encode, ZH_NUM_PHONEMES


def get_tokenizer(name: str):
    """``char_utf8``, ``phoneme_en`` or ``phoneme_zh``."""
    if name == "char_utf8":
        return byte_tokenizer()
    if name == "phoneme_en":
        return phoneme_en_tokenizer()
    if name == "phoneme_zh":
        return phoneme_zh_tokenizer()
    raise ValueError(f"unknown tokenizer '{name}'")
