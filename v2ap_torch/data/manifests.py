"""Corpus manifests: ``.scp`` / ``.json`` / ``.jsonl`` readers and the
typed corpus registry.

A copy of ``v2ap_tpu/data/manifests.py``. Formats (all host-side,
streaming):
  * ``.scp``  — tab-separated ``media_path\tcaption``
  * tango-style ``.json`` — {"data": [{"wav": ..., "caption": ...}, ...]}
  * ``.jsonl`` — one {"wav"/"location"/"path", "caption"/"captions"} per line
``pair_preferences`` folds ``a<id>`` / ``b<id>`` files of one directory
into preference pairs; ``load_corpora`` drops samples whose basename is in
a held-out set (the leakage guard).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Sample:
    path: str                       # audio file or video file
    caption: str
    corpus: str
    is_sound_effect: bool = False   # drives theta-ratio resampling
    is_video: bool = False          # conditioning comes from frames
    is_piano: bool = False          # roll stream + MIDI supervision
    pair_path: Optional[str] = None  # loser media of a preference pair (DPO)


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    name: str
    manifest: str
    enabled: bool = True
    is_sound_effect: bool = False
    is_video: bool = False
    is_piano: bool = False
    score_threshold: Optional[float] = None   # CLAP filter threshold
    limit: Optional[int] = None
    # DPO preference pairing: same-directory files ``a<id>`` / ``b<id>``
    # are the winner / loser of one preference pair of the same clip.
    # Paired samples carry ``pair_path``; unpaired files stay ordinary
    # samples.
    preference_pairs: bool = False


def _iter_scp(path: str) -> Iterator[tuple[str, str]]:
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) == 1:
                yield parts[0], ""
            else:
                yield parts[0], parts[1]


def _iter_json(path: str) -> Iterator[tuple[str, str]]:
    with open(path) as f:
        if path.endswith(".jsonl"):
            rows = (json.loads(l) for l in f if l.strip())
        else:
            rows = json.load(f).get("data", [])
        for row in rows:
            wav = row.get("wav") or row.get("location") or row.get("path")
            cap = row.get("caption") or row.get("captions") or ""
            if wav:
                yield wav, cap


def pair_preferences(rows: List[Sample]) -> List[Sample]:
    """Fold ``a<id>`` / ``b<id>`` same-directory rows into winner samples
    carrying ``pair_path`` (the loser). Files without a counterpart — or not
    following the a*/b* convention — pass through unchanged."""
    by_key: dict = {}
    for s in rows:
        d, name = os.path.split(s.path)
        if name[:1] in ("a", "b"):
            by_key.setdefault((d, name[1:]), {})[name[0]] = s
    out: List[Sample] = []
    consumed = set()
    for (d, rest), ab in by_key.items():
        if "a" in ab and "b" in ab:
            w, l = ab["a"], ab["b"]
            consumed.add(w.path)
            consumed.add(l.path)
            out.append(dataclasses.replace(w, pair_path=l.path))
    out.extend(s for s in rows if s.path not in consumed)
    return out


def load_corpus(spec: CorpusSpec) -> List[Sample]:
    if not spec.enabled or not os.path.exists(spec.manifest):
        return []
    it = (_iter_json(spec.manifest)
          if spec.manifest.endswith((".json", ".jsonl"))
          else _iter_scp(spec.manifest))
    out = []
    for path, caption in it:
        out.append(Sample(path=path, caption=caption, corpus=spec.name,
                          is_sound_effect=spec.is_sound_effect,
                          is_video=spec.is_video, is_piano=spec.is_piano))
        if spec.limit is not None and len(out) >= spec.limit:
            break
    if spec.preference_pairs:
        out = pair_preferences(out)
    return out


def load_corpora(specs: Sequence[CorpusSpec],
                 exclude_ids: Optional[set] = None) -> List[Sample]:
    """Concatenate corpora, filtering samples whose basename id is in
    ``exclude_ids`` (the test-set leakage guard)."""
    out: List[Sample] = []
    for spec in specs:
        for s in load_corpus(spec):
            if exclude_ids:
                stem = os.path.splitext(os.path.basename(s.path))[0]
                if stem in exclude_ids:
                    continue
            out.append(s)
    return out


def default_corpora(root: str) -> List[CorpusSpec]:
    """The 11-corpus text-audio mix and the video corpora under ``root``,
    as explicit specs."""
    j = lambda *p: os.path.join(root, *p)
    return [
        CorpusSpec("audiocaps", j("tango-master", "data", "train_audiocaps.json")),
        CorpusSpec("wavcaps_audioset_sl", j("audioset_sl.scp")),
        CorpusSpec("wavcaps_bbc", j("bbc.scp"), is_sound_effect=True),
        CorpusSpec("wavcaps_freesound", j("freesound.scp"), is_sound_effect=True),
        CorpusSpec("wavcaps_soundbible", j("tango-master", "data",
                                          "train_soundbible.json"),
                   is_sound_effect=True),
        CorpusSpec("audiogroup_effects", j("audiogroup.scp"),
                   is_sound_effect=True),
        CorpusSpec("audioset_af", j("audioset_af.scp")),
        CorpusSpec("tangopromptbank", j("TangoPromptBank", "data.json")),
        CorpusSpec("musiccaps", j("musiccaps.jsonl")),
        CorpusSpec("vggsound", j("vggsound_train.scp"), is_video=True),
        CorpusSpec("piano", j("piano_train.scp"), is_video=True, is_piano=True),
    ]
