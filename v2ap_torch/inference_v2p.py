"""Video-to-piano batch inference CLI of the port: ``inference_v2a`` with
the piano branch on (keyboard strips through Video2Roll), in both argv
forms, as ``inference_v2p.py`` takes them:

    python -m v2ap_torch.inference_v2p ckpts/model 0 tests/piano_test.scp 0 100 outputs/
    python -m v2ap_torch.inference_v2p --scp tests/piano_test.scp --out outputs/

In the positional form, as in the reference's CLI, only the first six
arguments are read (no manifest stride); ``--device``, ``--steps`` and
``--tiny`` may follow them. On a machine without cv2 each video's feature and roll (or
strip) caches must be beside it.
"""

from __future__ import annotations

import sys

from v2ap_torch import inference_v2a


def parse_args(argv):
    """The namespace ``inference_v2a`` runs, with ``piano`` on."""
    argv = list(argv)
    pos, flags = inference_v2a._split(argv)
    if argv and not argv[0].startswith("-"):
        args = inference_v2a.parse_args(pos[:6] + flags)
        args.piano = True
        return args
    if "--piano" not in argv:
        argv.append("--piano")
    return inference_v2a.parse_args(argv)


def main(argv=None) -> int:
    return inference_v2a.run(parse_args(argv if argv is not None
                                        else sys.argv[1:]))


if __name__ == "__main__":
    raise SystemExit(main())
