"""Merge chunked generation outputs and mux them back onto videos.

    # group consecutive chunk wavs (<stem>.00000000.wav ...) N at a time
    python -m v2ap_torch.merge_wavs concat --in-dir outs/ \\
        --out-dir outs_20s/ --group 2 [--overlap-ms 0]

    # mux each <stem>.wav onto the matching <stem>.mp4
    python -m v2ap_torch.merge_wavs mux --wav-dir outs/ --video-dir vids/ \\
        --out-dir muxed/

Counterpart of ``scripts/merge_wavs.py``, over the port's
``pipelines.merge.merge_wav_files`` and ``data.video_io.
mux_audio_onto_video``: ``--overlap-ms 0`` concatenates, a positive value
crossfades (equal power) at the joins; ``mux`` writes ``<stem>.wav``
beside each output and, with ffmpeg installed, the muxed ``<stem>.mp4``
(without ffmpeg a video counts as failed).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

_CHUNK_RE = re.compile(r"^(?P<stem>.+)\.(?P<idx>\d{8})\.wav$")


def collect_chunks(in_dir: str) -> dict:
    """{stem: [paths by chunk index]} over ``<stem>.%08d.wav`` files."""
    groups: dict = {}
    for p in sorted(glob.glob(os.path.join(in_dir, "*.wav"))):
        m = _CHUNK_RE.match(os.path.basename(p))
        if m:
            groups.setdefault(m.group("stem"), []).append(
                (int(m.group("idx")), p))
    return {s: [p for _, p in sorted(v)] for s, v in groups.items()}


def cmd_concat(args) -> int:
    from v2ap_torch.pipelines.merge import merge_wav_files

    os.makedirs(args.out_dir, exist_ok=True)
    groups = collect_chunks(args.in_dir)
    written = 0
    for stem, paths in groups.items():
        for i in range(0, len(paths), args.group):
            out = os.path.join(args.out_dir,
                               f"{stem}.{i // args.group + 1}.wav")
            merge_wav_files(paths[i: i + args.group], out,
                            crossfade_s=args.overlap_ms / 1000.0)
            written += 1
    print(f"wrote {written} merged wavs from {len(groups)} stems")
    return 0 if written else 1


def cmd_mux(args) -> int:
    from v2ap_torch.data.audio_io import read_wav
    from v2ap_torch.data.video_io import mux_audio_onto_video

    os.makedirs(args.out_dir, exist_ok=True)
    done = failed = 0
    for wav_path in sorted(glob.glob(os.path.join(args.wav_dir, "*.wav"))):
        stem = os.path.splitext(os.path.basename(wav_path))[0]
        video = os.path.join(args.video_dir, stem + ".mp4")
        if not os.path.exists(video):
            continue
        wav, sr = read_wav(wav_path)
        wav = wav[0] if wav.ndim == 2 else wav
        out = os.path.join(args.out_dir, stem + ".mp4")
        try:
            ok = mux_audio_onto_video(video, wav, sr, out)
        except (RuntimeError, OSError) as exc:
            print(f"mux failed for {stem}: {exc}", file=sys.stderr)
            ok = False
        done += ok
        failed += not ok
    print(f"muxed {done} videos ({failed} failed)")
    return 1 if failed or not done else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m v2ap_torch.merge_wavs",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("concat", help="group chunk wavs into longer files")
    c.add_argument("--in-dir", required=True)
    c.add_argument("--out-dir", required=True)
    c.add_argument("--group", type=int, default=2,
                   help="chunks per output (10 s chunks -> 20 s files)")
    c.add_argument("--overlap-ms", type=float, default=0.0,
                   help="crossfade at the joins; 0 concatenates")
    c.set_defaults(fn=cmd_concat)
    m = sub.add_parser("mux", help="mux <stem>.wav onto <stem>.mp4")
    m.add_argument("--wav-dir", required=True)
    m.add_argument("--video-dir", required=True)
    m.add_argument("--out-dir", required=True)
    m.set_defaults(fn=cmd_mux)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
