"""What a call's towers hand the correctness check under int8 towers, kept
by forward hooks on the device (no copy to the host, no sync):

  features   each tower's output, a chunk of frames a forward
  layers     of a few int8 ``Linear`` layers of each tower (``chosen``):
             ``ROWS`` rows of a forward's input and output, spread over its
             tokens and frames

``benchmark/families/v2ap.py``'s ``reference_readings`` holds the
features against the reference towers' frame by frame (``feature_gap``)
and each kept layer against ``reference.nn.int8_linear`` on the same input
rows (``layer_gap``). The hooks take any module tree whose linear layers
carry ``weight`` (out, in) and an ``int8`` flag: the port's towers, and
the reference's where the control computes them (``control.py
--fp8ref``).
"""

from __future__ import annotations

import torch

ROWS = 32
STRIDE = 7919           # a prime: rows r * STRIDE mod n, r < ROWS, differ


def empty() -> dict:
    return {"features": {}, "layers": {}}


def _linears(model) -> list:
    return [(name, m) for name, m in model.named_modules()
            if hasattr(m, "int8") and getattr(m, "weight", None) is not None
            and m.weight.dim() == 2]


def chosen(model) -> list:
    """The kept layers of a tower, by state-dict name: the first linear
    layer, the first of the widest output, the last of the widest input
    and the last (ViT-bigG: blocks.0.attn.q, blocks.0.mlp.fc1,
    blocks.47.mlp.fc2, visual_projection)."""
    lin = _linears(model)
    widest_out = max(m.weight.shape[0] for _, m in lin)
    widest_in = max(m.weight.shape[1] for _, m in lin)
    names = [lin[0][0],
             next(n for n, m in lin if m.weight.shape[0] == widest_out),
             [n for n, m in lin if m.weight.shape[1] == widest_in][-1],
             lin[-1][0]]
    return list(dict.fromkeys(names))


_INDEX: dict = {}


def _rows(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _INDEX:
        r = torch.arange(min(n, ROWS), device=device)
        _INDEX[key] = r if n <= ROWS else r * STRIDE % n
    return _INDEX[key]


def keep(model, tower: str, sink) -> None:
    """Hooks on ``model`` (tower ``tower``) that add to ``sink()``, a dict
    of ``empty``'s keys, while it is not None."""
    def features(module, args, out):
        store = sink()
        if store is not None:
            store["features"].setdefault(tower, []).append(out.detach())
    model.register_forward_hook(features)
    modules = dict(model.named_modules())
    for name in chosen(model):
        def layer(module, args, out, name=name):
            store = sink()
            if store is None:
                return
            x = args[0].reshape(-1, args[0].shape[-1])
            y = out.reshape(-1, out.shape[-1])
            idx = _rows(len(x), x.device)
            store["layers"].setdefault((tower, name), []).append(
                (x.index_select(0, idx), y.index_select(0, idx)))
        modules[name].register_forward_hook(layer)
