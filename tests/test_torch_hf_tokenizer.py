"""The port's Hugging Face tokenizer reader (``v2ap_torch/data/hf_tokenizer.py``)
against ``transformers`` and ``tokenizers`` on the CPU.

Two tokenizer directories are built here with ``tokenizers``, in the layouts
``transformers``' converters write: a T5-style Unigram (a sentencepiece
``Precompiled`` charsmap, written by the small darts-clone helper below,
then right strip and the ``" {2,}"`` replace; Metaspace; ``$A </s>``) and a
trained RoBERTa-style byte-level BPE (``RobertaProcessing``, ``<mask>`` with
lstrip). Ids and masks must equal exactly what the JAX package's calls give
(``load_t5_tokenizer``, and the ``AutoTokenizer`` call of
``make_clap_scorer``) over a fixed corpus and a hypothesis strategy; the
component variants the two directories do not use are held against
``tokenizers`` itself. The same directories are committed under
``tests/golden/tokenizers/`` with ``transformers``' ids of a corpus in
``tests/golden/tokenizer_ids.json`` (``chip_smoke.py`` reads them on a machine
without ``transformers``); ``python -m tests.test_torch_hf_tokenizer`` writes
them again.

End to end: ``V2APipeline(tokenizer_path=).encode_text`` against JAX's at
the tiny T5 (1e-4 relative RMS, ``tests/test_torch_t5.py``'s tolerance), and
the CLAP scorer with ``tokenizer_path=`` against JAX's (the CLAP parity
tolerance of ``tests/test_torch_eval.py``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import struct
import sys
import unicodedata

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                        normalizers, pre_tokenizers, processors, trainers)

from v2ap_torch.data import hf_tokenizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "tokenizers"
GOLDEN_IDS = ROOT / "tests" / "golden" / "tokenizer_ids.json"
CLAP_MAX_LENGTH = 64            # make_clap_scorer's
T5_EXTRA_IDS = 8


# ------------------------------------------------------ the darts-clone trie

def darts_units(keys: dict) -> list:
    """A darts-clone double array of ``keys`` (bytes -> value < 2^31), the
    layout sentencepiece stores a charsmap's trie in: each unit holds a
    label (bits 0-7), a has-leaf flag (bit 8) and the XOR offset of its
    children (bits 10-31); a leaf unit holds its value with bit 31 set. Each
    node's children get a 256-unit block of their own, so no two nodes
    share a base and no lookup can land on another node's child."""
    root: dict = {}
    for key, value in keys.items():
        node = root
        for byte in key:
            node = node.setdefault(byte, {})
        node[None] = value
    units: dict = {0: 0}
    blocks = [0]

    def place(node: dict, pos: int) -> None:
        blocks[0] += 1
        base = 256 * blocks[0]
        offset = pos ^ base
        assert offset < 1 << 21           # no extension bit needed
        units[pos] = (offset << 10) | (int(None in node) << 8) | units[pos]
        if None in node:
            units[base] = node[None] | 1 << 31
        for byte in sorted(b for b in node if b is not None):
            units[base ^ byte] = byte
            place(node[byte], base ^ byte)

    place(root, 0)
    return [units.get(i, 0) for i in range(max(units) + 1)]


def precompiled_charsmap(mapping: dict) -> bytes:
    """sentencepiece's precompiled charsmap of ``mapping`` (str -> str): the
    trie's byte size (u32), the trie, then the NUL-terminated replacements
    the trie's values point at."""
    blob, keys = b"", {}
    for key, value in mapping.items():
        keys[key.encode()] = len(blob)
        blob += value.encode() + b"\0"
    units = darts_units(keys)
    return (struct.pack("<I", 4 * len(units))
            + struct.pack(f"<{len(units)}I", *units) + blob)


# full-width ASCII, a ligature, no-break and ideographic spaces, control
# characters, a zero-width space removed, two-code-point keys (one the
# prefix of a three-code-point key: the shortest match wins)
CHARSMAP = {
    **{chr(0xFF01 + i): chr(0x21 + i) for i in range(94)},
    "\ufb01": "fi", "\ufb02": "fl", "\u00a0": " ", "\u3000": " ",
    "\t": " ", "\n": " ", "\r": " ", "\u200b": "",
    "e\u0301": "\u00e9", "a\u0300": "\u00e0", "a\u0300\u0301": "\u01df",
    "\u2126": "\u03a9", "\u2460": "1",
}


# ------------------------------------------------------- the two tokenizers

T5_WORDS = (
    "the sound of a an and with in on at is are dog dogs bark barking "
    "piano play playing plays music rain falling roof man speaks car cars "
    "pass bird birds chirp wind blowing keyboard engine water crowd cheer "
    "thunder violin cello glass footsteps ocean waves clock tick cat meow "
    "jazz bass electronic beep chimes loud soft softly large hall hz "
    "café crème naïve fish five").split()
T5_SUFFIXES = ("ing", "ed", "er", "s", "ly", "es", "ion", "ful")
T5_CHARS = ("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
            ".,;:!?'\"()-&/<>@#%+=*_~[]{}|éèàüö"
            "ñçïâôǟΩ雨の音"
            "犬楽")


def t5_vocab() -> list:
    """(piece, score) rows: T5's three specials, then pieces scored by a
    fixed formula (words beat their letters, some suffixes beat letters),
    then the extra ids in T5Converter's (reversed) order."""
    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -2.5)]
    seen = {p for p, _ in vocab}

    def add(piece, score):
        if piece not in seen:
            seen.add(piece)
            vocab.append((piece, score))

    for i, word in enumerate(T5_WORDS):
        add("▁" + word, -3.0 - 0.25 * (i % 7) - 0.1 * len(word))
        if len(word) > 4:
            add(word[:3], -6.0 - 0.1 * i % 1.3)
            add("▁" + word[:2], -7.5 + 0.05 * (i % 5))
    for i, suffix in enumerate(T5_SUFFIXES):
        add(suffix, -4.0 - 0.3 * i)
    for i, ch in enumerate(T5_CHARS):
        add(ch, -8.0 - 0.01 * i)
        add("▁" + ch, -8.5 - 0.01 * i)
    vocab += [(f"<extra_id_{i}>", 0.0)
              for i in range(T5_EXTRA_IDS - 1, -1, -1)]
    return vocab


def t5_tokenizer(charsmap: dict = CHARSMAP, prepend_scheme="always",
                 split=True, byte_fallback=False, vocab=None) -> Tokenizer:
    """The layout of transformers' T5Converter (SpmConverter): Unigram, the
    Precompiled charsmap + right strip + ``" {2,}"`` -> ``▁``, Metaspace,
    ``$A </s>``, the specials and extra ids as special added tokens."""
    vocab = vocab or t5_vocab()
    tok = Tokenizer(models.Unigram(vocab, unk_id=2,
                                   byte_fallback=byte_fallback))
    tok.normalizer = normalizers.Sequence([
        normalizers.Precompiled(precompiled_charsmap(charsmap)),
        normalizers.Strip(left=False, right=True),
        normalizers.Replace(Regex(" {2,}"), "▁")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme=prepend_scheme, split=split)
    tok.decoder = decoders.Metaspace(replacement="▁",
                                     prepend_scheme=prepend_scheme)
    tok.post_processor = processors.TemplateProcessing(
        single=["$A", "</s>"], pair=["$A", "</s>", "$B", "</s>"],
        special_tokens=[("</s>", 1)])
    tok.add_special_tokens([
        AddedToken(p, normalized=False, special=True) for p, _ in vocab
        if p in ("<pad>", "</s>", "<unk>") or p.startswith("<extra_id_")])
    return tok


ROBERTA_SPECIALS = ("<s>", "<pad>", "</s>", "<unk>", "<mask>")
ROBERTA_CORPUS = (
    "the sound of a dog barking in the distance",
    "a piano playing softly in a large concert hall",
    "rain falling on a tin roof while thunder rumbles",
    "a man speaks while cars pass by on a wet road",
    "birds are chirping and the wind is blowing",
    "someone is typing loudly on a mechanical keyboard",
    "an engine revs and then idles for a while",
    "children laughing and playing at the park",
    "a violin and a cello play a slow duet",
    "glass shatters and people gasp",
    "footsteps crunch on gravel at night",
    "ocean waves crash against the rocks",
    "a crowd cheers after the goal",
    "water drips into a metal sink",
    "it's raining, we're inside, they've left and I'll stay",
    "jazz piano with a walking bass line and brushed drums",
    "electronic beeps at 440 Hz and 880 Hz",
    "wind chimes ring gently in the breeze",
)


def roberta_tokenizer() -> Tokenizer:
    """RobertaConverter's layout: byte-level BPE trained here on a fixed
    corpus (specials first, as in roberta-base: <s> 0, <pad> 1, </s> 2,
    <unk> 3), ByteLevel without a prefix space, RobertaProcessing, and
    ``<mask>`` as a special token with lstrip."""
    trainer_tok = Tokenizer(models.BPE())
    trainer_tok.pre_tokenizer = pre_tokenizers.ByteLevel(
        add_prefix_space=False)
    trainer_tok.train_from_iterator(
        list(ROBERTA_CORPUS) * 3, trainers.BpeTrainer(
            vocab_size=420, min_frequency=2, show_progress=False,
            special_tokens=list(ROBERTA_SPECIALS),
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    trained = json.loads(trainer_tok.to_str())["model"]
    merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
              for m in trained["merges"]]
    tok = Tokenizer(models.BPE(trained["vocab"], merges, dropout=None,
                               continuing_subword_prefix="",
                               end_of_word_suffix="", fuse_unk=False))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.RobertaProcessing(
        sep=("</s>", 2), cls=("<s>", 0), trim_offsets=True,
        add_prefix_space=False)
    tok.add_special_tokens([
        AddedToken(t, normalized=False, special=True, lstrip=t == "<mask>")
        for t in ROBERTA_SPECIALS])
    return tok


def tokenizer_files(kind: str) -> dict:
    """file name -> JSON object of a tokenizer directory, as a published
    snapshot holds them (``tokenizer.json`` with the configs of the
    transformers class)."""
    if kind == "t5":
        extra = [f"<extra_id_{i}>" for i in range(T5_EXTRA_IDS)]
        special = {"eos_token": "</s>", "unk_token": "<unk>",
                   "pad_token": "<pad>", "additional_special_tokens": extra}
        config = {"tokenizer_class": "T5Tokenizer", "model_max_length": 512,
                  "extra_ids": T5_EXTRA_IDS, **special}
        tok = t5_tokenizer()
    else:
        special = {"bos_token": "<s>", "eos_token": "</s>",
                   "sep_token": "</s>", "cls_token": "<s>",
                   "unk_token": "<unk>", "pad_token": "<pad>",
                   "mask_token": "<mask>"}
        config = {"tokenizer_class": "RobertaTokenizer",
                  "model_max_length": 512, "add_prefix_space": False,
                  "trim_offsets": True, "errors": "replace", **special}
        tok = roberta_tokenizer()
    return {"tokenizer.json": json.loads(tok.to_str()),
            "tokenizer_config.json": config,
            "special_tokens_map.json": special}


def write_tokenizer_dir(kind: str, path: pathlib.Path) -> pathlib.Path:
    path.mkdir(parents=True, exist_ok=True)
    for name, obj in tokenizer_files(kind).items():
        (path / name).write_text(json.dumps(obj, indent=1, ensure_ascii=False)
                                 + "\n", encoding="utf-8")
    return path


# ------------------------------------------------------------- the corpus

BASE = (
    "the sound of a dog barking", "a piano playing softly in a large hall",
    "Rain falling on a tin roof", "a man speaks while cars pass by",
    "birds chirping; wind blowing", "Someone's typing on a keyboard - loudly!",
    "an engine revving, then idling", "Children laughing at the park (distant)",
    "thunder rumbles 3 times", "a violin & cello duet", "glass shattering!!!",
    "footsteps on gravel...", "ocean waves crashing at 5:30 a.m.",
    "A CROWD CHEERS", "water dripping into a sink",
    "the clock ticks: tick-tock", "a cat meows twice",
    "jazz piano with a walking bass line", "electronic beeps, 440 Hz",
    "wind chimes in the breeze", "it's raining, we're in, they've gone",
    "I'll stay; he'd go; I'm here", "soft_rain #2 @home [quiet] {calm}",
    "50% louder = 2x energy", "café crème brûlée",
)
SPECIAL_CASES = (
    "", " ", "   ", "\t\n", "　", "x\r\ny", "a  b   c    d",
    unicodedata.normalize("NFD", "café crème naïve façade"),
    "naïve façade", "Ａｌｌ ｆｕｌｌ"
    "－ｗｉｄｔｈ １２３",
    "ﬁve ﬁsh ﬂute", "non breaking space",
    "à and à́ and à́̂",
    "zero​width​", "雨の音と犬",
    "音楽 music", "\U0001F3B9 piano \U0001F3B6",
    "\U0001F468‍\U0001F469‍\U0001F467 family laughing",
    "\U0001F1EF\U0001F1F5 flag", "1️⃣ keycap", "a\U0001F3FB",
    "123 4567 89.5 0.001", "!!! ??? ... ,,, ;;; -- ''", "Ω ①",
    "<extra_id_3> a sound", "a<extra_id_0>b", "a <mask> barking",
    "a<mask>", "  <mask>  x", "</s> in text", "<pad><pad>", "<s>hello</s>",
    "क्ष नमस्ते",
    "مرحبا שלום",
    "é" * 40, " leading", "trailing ", "  both  ", "\ttab",
    "x́", "́x", " ́",
)


def corpus() -> list:
    """The fixed prompts (239): each base caption as it is, with leading,
    trailing and doubled spaces, in upper case, with a tab, a newline and
    a carriage return; the special cases; two prompts past every
    max_length (T5's 512 tokens, CLAP's 64)."""
    out = []
    for base in BASE:
        out += [base, "  " + base, base + "   ", base.replace(" ", "  "),
                base.upper(), base.replace(" ", "\t", 1),
                base.replace(" ", "\n", 1) + "\r\n", " " + base + " "]
    out += SPECIAL_CASES
    long = " ".join(BASE)
    out += [long, " ".join([long] * 6)]
    return out


def golden_prompts() -> list:
    """The prompts of the golden ids: every fifth of the corpus (48) and
    the two long ones."""
    prompts = corpus()
    return prompts[:-2:5] + prompts[-2:]


# ------------------------------------------------------- transformers' side

def jax_t5_encode(path):
    """The JAX package's T5 tokenizer call (``load_t5_tokenizer``)."""
    from v2ap_tpu.pipelines.generate import load_t5_tokenizer
    return load_t5_tokenizer(str(path), 32128)


def jax_clap_encode(path):
    """The tokenizer call of the JAX package's ``make_clap_scorer``."""
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(str(path))

    def encode(captions):
        out = tok(list(captions), padding=True, truncation=True,
                  max_length=CLAP_MAX_LENGTH, return_tensors="np")
        return (out["input_ids"].astype(np.int32),
                out["attention_mask"].astype(np.int32))
    return encode


def golden_ids() -> dict:
    """transformers' ids and masks of ``golden_prompts()`` for the committed
    directories, in the JAX package's two calls."""
    prompts = golden_prompts()
    out = {"prompts": prompts}
    for kind, make in (("t5", jax_t5_encode), ("roberta", jax_clap_encode)):
        ids, mask = make(GOLDEN / kind)(prompts)
        out[kind] = {"input_ids": ids.tolist(),
                     "attention_mask": mask.tolist()}
    return out


def write_golden() -> None:
    for kind in ("t5", "roberta"):
        write_tokenizer_dir(kind, GOLDEN / kind)
    GOLDEN_IDS.write_text(json.dumps(golden_ids(), ensure_ascii=False)
                          + "\n", encoding="utf-8")


# ------------------------------------------------------------------ tests

@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    return {kind: write_tokenizer_dir(kind, root / kind)
            for kind in ("t5", "roberta")}


@pytest.fixture(scope="module")
def encoders(dirs):
    """(port, transformers) encoders of each directory, in the JAX
    package's calls."""
    return {
        "t5": (hf_tokenizer.load_t5(dirs["t5"]), jax_t5_encode(dirs["t5"])),
        "roberta": (hf_tokenizer.load_clap(dirs["roberta"]),
                    jax_clap_encode(dirs["roberta"]))}


def test_charsmap_reads_in_tokenizers():
    """The darts-clone helper's trie reads in ``tokenizers``' Precompiled
    as written: every key maps, the shortest key of a grapheme wins, a
    grapheme of 6 bytes or more maps code point by code point."""
    norm = normalizers.Precompiled(precompiled_charsmap(CHARSMAP))
    for key, value in CHARSMAP.items():
        if key != "à́":
            assert norm.normalize_str(key) == value, repr(key)
    assert norm.normalize_str("à́") == "à"
    assert norm.normalize_str("x\r\ny") == "x y"        # one grapheme
    assert norm.normalize_str("Ａﬁ ") == "Afi "


def test_corpus_is_the_stated_one():
    prompts = corpus()
    assert len(prompts) >= 200 and "" in prompts
    t5 = hf_tokenizer.load_t5(GOLDEN / "t5")
    assert len(t5.encode(prompts[-1])) > 512
    clap = hf_tokenizer.load_clap(GOLDEN / "roberta")
    assert sum(len(clap.encode(p)) > CLAP_MAX_LENGTH for p in prompts) > 2


@pytest.mark.parametrize("kind", ["t5", "roberta"])
def test_corpus_ids_equal_transformers(encoders, kind):
    """The fixed corpus, one batch and prompt by prompt: ids and masks
    exactly equal, int32, right-padded with the pad id, truncated as
    transformers truncates."""
    port, ref = encoders[kind]
    prompts = corpus()
    ids, mask = port(prompts)
    want_ids, want_mask = ref(prompts)
    assert ids.dtype == mask.dtype == np.int32
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    for p in prompts:
        got, want = port([p]), ref([p])
        np.testing.assert_array_equal(got[0], want[0], err_msg=repr(p))
        np.testing.assert_array_equal(got[1], want[1], err_msg=repr(p))


TEXT = st.text(
    alphabet=st.one_of(
        st.sampled_from(" \t\n\r 　​‍'-.,!?<>/s"),
        st.sampled_from("".join(CHARSMAP) + T5_CHARS),
        st.characters(codec="utf-8", exclude_categories=("Cs", "Co", "Cn"))),
    max_size=40)


@pytest.mark.parametrize("kind", ["t5", "roberta"])
@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(texts=st.lists(TEXT, min_size=1, max_size=4))
def test_hypothesis_ids_equal_transformers(encoders, kind, texts):
    port, ref = encoders[kind]
    ids, mask = port(texts)
    want_ids, want_mask = ref(texts)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)


def _variant_cases():
    vocab = t5_vocab()
    fallback = vocab + [(f"<0x{b:02X}>", -20.0) for b in range(256)]
    cases = {
        "metaspace_first": t5_tokenizer(prepend_scheme="first"),
        "metaspace_never": t5_tokenizer(prepend_scheme="never"),
        "metaspace_no_split": t5_tokenizer(split=False),
        "unigram_byte_fallback": t5_tokenizer(byte_fallback=True,
                                              vocab=fallback),
    }
    legacy = json.loads(t5_tokenizer().to_str())
    # the published T5 layout: WhitespaceSplit before a Metaspace written
    # with the older add_prefix_space field, the charsmap alone
    legacy["normalizer"] = legacy["normalizer"]["normalizers"][0]
    legacy["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"},
        {"type": "Metaspace", "replacement": "▁",
         "add_prefix_space": True}]}
    cases["t5_published_layout"] = Tokenizer.from_str(json.dumps(legacy))
    words = {"<unk>": 0, "a": 1, "b": 2, "c": 3, "##b": 4, "##c": 5,
             "ab": 6, "abc": 7, "c</w>": 8, "##c</w>": 9, "abc</w>": 10,
             "Ġ": 11, "Ġa": 12}
    for name, kw in {
            "bpe_unk_fuse": dict(unk_token="<unk>", fuse_unk=True),
            "bpe_unk_no_fuse": dict(unk_token="<unk>", fuse_unk=False),
            "bpe_prefix": dict(unk_token="<unk>",
                               continuing_subword_prefix="##"),
            "bpe_suffix": dict(unk_token="<unk>", end_of_word_suffix="</w>"),
            "bpe_ignore_merges": dict(unk_token="<unk>", ignore_merges=True),
    }.items():
        merges = ([("a", "##b"), ("ab", "##c")] if name == "bpe_prefix"
                  else [("a", "b"), ("ab", "c</w>")] if name == "bpe_suffix"
                  else [("a", "b"), ("Ġ", "a")])
        tok = Tokenizer(models.BPE(words, merges, **kw))
        tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
        tok.post_processor = processors.TemplateProcessing(
            single="<unk> $A <unk>", special_tokens=[("<unk>", 0)])
        cases[name] = tok
    prefix = roberta_tokenizer()
    prefix.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    cases["bytelevel_prefix_space"] = prefix
    return cases


VARIANT_TEXTS = (
    "", "  ", "abc", "ab abc c", "abcab xyz", "aéb", "the  sound ",
    " lead", "<extra_id_1>x  y", "x<extra_id_1> y", "雨の\U0001F3B9",
    "it's 12 o'clock!!", "à́ é", "    x",
)


@pytest.mark.parametrize("name", sorted(_variant_cases()))
def test_component_variants_equal_tokenizers(tmp_path, name):
    """Options the two directories leave at one value (Metaspace's prepend
    schemes and split, the published T5 layout, Unigram's byte fallback,
    BPE's unk fusing, subword prefix and suffix and ignore_merges,
    ByteLevel's prefix space), each against ``tokenizers`` itself."""
    tok = _variant_cases()[name]
    (tmp_path / "tokenizer.json").write_text(tok.to_str(), encoding="utf-8")
    port = hf_tokenizer.HFTokenizer(tmp_path)
    for text in VARIANT_TEXTS + tuple(corpus()[::7]):
        assert port.encode(text) == tok.encode(text).ids, (name, repr(text))


@pytest.mark.parametrize("section,component", [
    ("normalizer", {"type": "NFKC"}),
    ("pre_tokenizer", {"type": "BertPreTokenizer"}),
    ("model", {"type": "WordPiece", "vocab": {}, "unk_token": "[UNK]"}),
    ("post_processor", {"type": "BertProcessing", "sep": ["[SEP]", 1],
                        "cls": ["[CLS]", 0]}),
    ("decoder", None),
])
def test_unsupported_components_raise_by_name(tmp_path, section, component):
    files = tokenizer_files("t5")
    if component is None:                 # decoders are not read: any type
        files["tokenizer.json"]["decoder"] = {"type": "WordPiece"}
    else:
        files["tokenizer.json"][section] = component
    for name, obj in files.items():
        (tmp_path / name).write_text(json.dumps(obj), encoding="utf-8")
    if component is None:
        assert hf_tokenizer.load_t5(tmp_path)(["a dog"])[0].shape == (1, 3)
        return
    with pytest.raises(NotImplementedError, match=component["type"]):
        hf_tokenizer.load_t5(tmp_path)


def test_model_max_length_absent_truncates_nothing(tmp_path):
    """With no model_max_length, transformers' very large default applies:
    the port truncates nothing, as transformers does without truncation (the
    JAX package's call itself overflows converting 1e30 for the crate)."""
    files = tokenizer_files("t5")
    del files["tokenizer_config.json"]["model_max_length"]
    for name, obj in files.items():
        (tmp_path / name).write_text(json.dumps(obj), encoding="utf-8")
    from transformers import AutoTokenizer
    prompts = [corpus()[-1], "a dog"]
    ids, mask = hf_tokenizer.load_t5(tmp_path)(prompts)
    want = AutoTokenizer.from_pretrained(str(tmp_path))(
        prompts, padding=True, return_tensors="np")
    assert ids.shape[1] > 512
    np.testing.assert_array_equal(ids, want["input_ids"])
    np.testing.assert_array_equal(mask, want["attention_mask"])
    with pytest.raises(OverflowError):
        jax_t5_encode(tmp_path)(prompts)


def test_golden_directories_are_the_generators():
    """The committed directories are exactly what the generator writes, and
    the committed ids are what transformers gives today."""
    for kind in ("t5", "roberta"):
        for name, obj in tokenizer_files(kind).items():
            got = json.loads((GOLDEN / kind / name).read_text("utf-8"))
            assert got == obj, (kind, name)
    assert json.loads(GOLDEN_IDS.read_text("utf-8")) == golden_ids()


@pytest.mark.parametrize("kind", ["t5", "roberta"])
def test_golden_ids_equal_port(kind):
    """What ``chip_smoke.py`` checks on the card, here."""
    golden = json.loads(GOLDEN_IDS.read_text("utf-8"))
    load = hf_tokenizer.load_t5 if kind == "t5" else hf_tokenizer.load_clap
    ids, mask = load(GOLDEN / kind)(golden["prompts"])
    np.testing.assert_array_equal(ids, golden[kind]["input_ids"])
    np.testing.assert_array_equal(mask, golden[kind]["attention_mask"])


# ------------------------------------------------------------ end to end

def test_pipeline_encode_text_with_tokenizer_path_matches_jax():
    """``V2APipeline(tokenizer_path=)`` in both packages (the tiny T5 widened
    to the tokenizer's vocabulary, the same weights): masks equal, hidden
    states within T5's 1e-4 relative RMS, the width the longest prompt's."""
    from tests.test_torch_models import rel_rms
    from tests.test_torch_ops import flatten_jax, randomize_jax
    from tests.test_torch_pipeline import _cfg
    from v2ap_torch import config as t_config
    from v2ap_torch.models.clip_vit import clip_tiny_test
    from v2ap_torch.models.t5 import t5_tiny_test
    from v2ap_torch.pipelines.generate import V2APipeline
    from v2ap_torch.utils.convert import load_jax_params
    from v2ap_tpu import config as j_config
    from v2ap_tpu.models.clip_vit import clip_tiny_test as j_clip_tiny
    from v2ap_tpu.models.t5 import t5_tiny_test as j_t5_tiny
    from v2ap_tpu.pipelines.generate import V2APipeline as JPipeline

    path = str(GOLDEN / "t5")
    vocab = len(json.loads((GOLDEN / "t5" / "tokenizer.json").read_text(
        "utf-8"))["model"]["vocab"])
    jp = JPipeline(_cfg(j_config), tokenizer_path=path,
                   t5_config=dataclasses.replace(j_t5_tiny(),
                                                 vocab_size=vocab),
                   clip_config=j_clip_tiny(), quantize_towers=False)
    randomize_jax(jp.t5, 31, scale=0.05)
    tp = V2APipeline(_cfg(t_config), device="cpu", tokenizer_path=path,
                     t5_config=dataclasses.replace(t5_tiny_test(),
                                                   vocab_size=vocab),
                     clip_config=clip_tiny_test(), quantize_towers=False)
    load_jax_params(tp.t5, flatten_jax(jp.t5))
    prompts = ["a calm piano piece in a quiet room", "rain",
               "Ｔhe  sound of ﬁve dogs barking, then thunder!"]
    want, want_mask = jp.encode_text(prompts)
    got, mask = tp.encode_text(prompts)
    width = max(len(tp.tokenize.encode(p)) for p in prompts)
    assert got.shape[:2] == mask.shape == (3, width) and width != 64
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert rel_rms(got.float().numpy(), np.asarray(want)) < 1e-4


def test_clap_scorer_with_tokenizer_path_matches_jax(monkeypatch):
    """Both packages' CLAP scorers with ``tokenizer_path=`` the RoBERTa
    directory and the same tiny weights (the text tower widened to the
    tokenizer): the same scores, a caption past 64 tokens included."""
    from flax import nnx

    from tests.test_torch_ops import flatten_jax, randomize_jax
    from v2ap_torch.evaluation import clap_scorer as t_scorer
    from v2ap_torch.models import clap as t_clap
    from v2ap_torch.utils.convert import load_jax_params
    from v2ap_tpu.evaluation import clap_scorer as j_scorer
    from v2ap_tpu.models import clap as j_clap
    from v2ap_tpu.utils import jitting

    def widen(text):
        return dataclasses.replace(text, vocab_size=420,
                                   max_position_embeddings=70)

    a, t = j_clap.clap_tiny_test()
    jm = jitting.create_model(
        lambda: j_clap.ClapModel(a, widen(t), rngs=nnx.Rngs(0)))
    randomize_jax(jm, 3, scale=0.2)
    ta, tt = t_clap.clap_tiny_test()
    tm = t_clap.ClapModel(ta, widen(tt), device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    monkeypatch.setattr(jitting, "create_model", lambda build: jm)
    monkeypatch.setattr(t_clap, "ClapModel", lambda *a, **k: tm)
    path = str(GOLDEN / "roberta")
    want = j_scorer.make_clap_scorer(a, widen(t), tokenizer_path=path)
    got = t_scorer.make_clap_scorer(ta, widen(tt), tokenizer_path=path,
                                    device="cpu")
    wav = (np.random.default_rng(4).normal(size=48_000) * 0.1).astype(
        np.float32)
    for caption in ("a dog barks", corpus()[-2], "the <mask> of rain"):
        assert abs(got(wav, caption) - want(wav, caption)) < 1e-5, caption


if __name__ == "__main__":
    sys.exit(write_golden())
