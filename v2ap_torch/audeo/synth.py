"""Piano-roll -> MIDI notes -> audio synthesis / MIDI file export, numpy on
the host.

Counterpart of ``v2ap_tpu/audeo/synth.py`` (the port's own copy: that
module imports no JAX, but the port imports nothing of the JAX package).
It replaces the reference's FluidSynth+pretty_midi chain
(src/audeo/Midi_synth.py): the note-extraction math is identical (onset =
key appears, offset = key disappears, 0.04 s per frame, velocity 100,
MIDI pitch = key index + 21), but synthesis is dependency-free:

  * ``synthesize_notes``: vectorised additive piano synthesizer (harmonic
    stack with exponential decay + attack envelope) — no native FluidSynth
    needed; the waveform table is computed with numpy on host (synthesis is
    an offline, non-hot path; SURVEY §2.6 keeps it on CPU).
  * ``write_midi_file``: minimal Standard MIDI File (format 0) writer.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

SPF = 0.04                 # seconds per roll frame (25 Hz)
MIDI_BASE_KEY = 21         # lowest piano key (A0) in MIDI numbering


def roll_to_notes(roll: np.ndarray, min_key: int = 15,
                  piano_keys: int = 88) -> Dict[int, List[Tuple[int, int]]]:
    """Binary roll (frames, keys) -> {midi_pitch: [(start_f, end_f), ...]}.

    ``min_key`` offsets reduced-range rolls (51-key models cover keys
    15..65 of the 88-key piano, reference Midi_synth.py:15-16)."""
    roll = (roll > 0).astype(np.int8)
    frames, keys = roll.shape
    padded = np.concatenate([np.zeros((1, keys), np.int8), roll,
                             np.zeros((1, keys), np.int8)])
    diff = np.diff(padded, axis=0)           # +1 onset, -1 offset
    notes: Dict[int, List[Tuple[int, int]]] = {}
    for k in range(keys):
        onsets = np.where(diff[:, k] == 1)[0]
        offsets = np.where(diff[:, k] == -1)[0]
        if len(onsets):
            notes[MIDI_BASE_KEY + min_key + k] = list(
                zip(onsets.tolist(), offsets.tolist()))
    return notes


_TONE_CACHE: dict = {}
_MAX_PARTIALS = 16


def _piano_tone(freq: float, dur_s: float, sr: int,
                velocity: int = 100) -> np.ndarray:
    """Additive piano tone: inharmonic partial stack (stiff-string
    f_h = h·f0·sqrt(1+B·h²)), velocity-dependent brightness, double decay
    (fast "prompt" + slow "aftersound" — the classic two-stage piano decay),
    soft hammer attack, and a damper release tail.

    Physically-motivated stand-in for the reference's FluidSynth+soundfont
    rendering (src/audeo/Midi_synth.py:4,147) — no native synth dependency;
    tests/test_torch_audeo.py holds its output equal to the JAX package's."""
    key = (round(freq, 2), round(dur_s, 3), sr, velocity)
    hit = _TONE_CACHE.get(key)
    if hit is not None:
        return hit
    n = max(int(dur_s * sr), 1)
    t = np.arange(n) / sr
    # string stiffness: audible partial stretch, larger toward the treble
    b_coef = 1.4e-4 * (freq / 261.63) ** 0.8
    # louder hits excite upper partials more (hammer felt compresses)
    vel = np.clip(velocity / 127.0, 0.0, 1.0)
    brightness = 0.55 + 0.4 * vel
    wave = np.zeros(n, np.float64)
    for h in range(1, _MAX_PARTIALS + 1):
        f = freq * h * np.sqrt(1.0 + b_coef * h * h)
        if f >= sr / 2:
            break
        amp = brightness ** (h - 1) / h
        # per-partial double decay: a fast strike component plus a slow
        # singing component; both decay faster for higher partials/pitches
        d_fast = 8.0 + 0.002 * f
        d_slow = 0.9 + 0.0006 * f
        env_h = 0.35 * np.exp(-d_fast * t) + 0.65 * np.exp(-d_slow * t)
        # slight detune-beat of the prompt sound (unison strings)
        phase = 2 * np.pi * f * t
        wave += amp * env_h * np.sin(phase)
    attack = min(max(int(0.004 * sr), 1), n)
    env = np.ones(n)
    env[:attack] = np.linspace(0.0, 1.0, attack) ** 2   # soft hammer onset
    # damper: exponential stop over the final release window
    release = min(int(0.06 * sr), n)
    if release > 1:
        env[-release:] *= np.exp(-np.linspace(0.0, 5.0, release))
    out = (wave * env).astype(np.float32)
    # bound memory on huge rolls: ~1024 tones x ~150 KB ~= 150 MB worst case
    if len(_TONE_CACHE) < 1024:
        _TONE_CACHE[key] = out
    return out


def synthesize_notes(notes: Dict[int, List[Tuple[int, int]]],
                     sr: int = 16_000, spf: float = SPF,
                     velocity: int = 100, tail_s: float = 1.0) -> np.ndarray:
    """Render extracted notes to a waveform."""
    if not notes:
        return np.zeros(sr, np.float32)
    last = max(end for segs in notes.values() for _, end in segs)
    total = int((last * spf + tail_s) * sr) + 1
    out = np.zeros(total, np.float32)
    vel = velocity / 127.0
    for pitch, segs in notes.items():
        freq = 440.0 * 2.0 ** ((pitch - 69) / 12.0)
        for start_f, end_f in segs:
            dur = max((end_f - start_f) * spf, spf) + 0.3   # ring past release
            tone = _piano_tone(freq, dur, sr, velocity) * vel * 0.2
            s = int(start_f * spf * sr)
            e = min(s + len(tone), total)
            out[s:e] += tone[: e - s]
    peak = np.abs(out).max()
    if peak > 1.0:
        out /= peak
    return out


def _varlen(n: int) -> bytes:
    """MIDI variable-length quantity."""
    buf = [n & 0x7F]
    n >>= 7
    while n:
        buf.append((n & 0x7F) | 0x80)
        n >>= 7
    return bytes(reversed(buf))


def write_midi_file(path: str, notes: Dict[int, List[Tuple[int, int]]],
                    spf: float = SPF, velocity: int = 100,
                    tempo_bpm: float = 80.0, program: int = 0) -> None:
    """Minimal format-0 Standard MIDI File writer."""
    ppq = 480
    ticks_per_sec = ppq * tempo_bpm / 60.0
    events: List[Tuple[int, bytes]] = []
    for pitch, segs in notes.items():
        for start_f, end_f in segs:
            on = int(start_f * spf * ticks_per_sec)
            off = int(max(end_f, start_f + 1) * spf * ticks_per_sec)
            events.append((on, bytes([0x90, pitch, velocity])))
            events.append((off, bytes([0x80, pitch, 0])))
    events.sort(key=lambda e: e[0])

    track = bytearray()
    track += _varlen(0) + bytes([0xC0, program])               # program change
    tempo = int(60_000_000 / tempo_bpm)
    track += _varlen(0) + bytes([0xFF, 0x51, 0x03]) + struct.pack(">I", tempo)[1:]
    prev = 0
    for tick, msg in events:
        track += _varlen(tick - prev) + msg
        prev = tick
    track += _varlen(0) + bytes([0xFF, 0x2F, 0x00])            # end of track

    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, ppq))
        f.write(b"MTrk" + struct.pack(">I", len(track)) + bytes(track))


class MidiSynth:
    """Offline roll/MIDI synthesis (the reference MIDISynth class shape:
    load chunked roll npz files, binarise, extract notes, synthesize)."""

    def __init__(self, sr: int = 16_000, min_key: int = 15,
                 frames_per_chunk: int = 50, piano_keys: int = 88):
        self.sr = sr
        self.min_key = min_key
        self.frames_per_chunk = frames_per_chunk
        self.piano_keys = piano_keys

    def rolls_from_npz_dir(self, folder: str, key: str = "roll") -> np.ndarray:
        import glob
        import os
        files = glob.glob(os.path.join(folder, "*.npz"))
        files.sort(key=lambda x: int(
            os.path.basename(x).split(".")[0].split("-")[0]))
        chunks = []
        for f in files:
            with np.load(f) as data:
                roll = data[key]
            if roll.shape[0] != self.frames_per_chunk:
                pad = np.zeros((self.frames_per_chunk, roll.shape[1]))
                pad[: roll.shape[0]] = roll
                roll = pad
            chunks.append((roll > 0).astype(np.int8))
        return np.concatenate(chunks) if chunks else np.zeros((0, 88), np.int8)

    def synthesize_roll(self, roll: np.ndarray, min_key: int | None = None
                        ) -> np.ndarray:
        notes = roll_to_notes(roll, self.min_key if min_key is None else min_key)
        return synthesize_notes(notes, sr=self.sr)
