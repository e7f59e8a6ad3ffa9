"""Duration predictor and the character embeddings of the token path.

Counterpart of ``v2ap_tpu/models/duration.py``:

  * ``CharacterEmbed``: token ids (b, nt), -1 padded, shifted up by one so
    that padding lands on a zero-id "filler" row, curtailed or zero-padded
    to the latent length, then looked up: (b, length, dim_text) float32.
  * ``InterpolatedCharacterEmbed``: the valid tokens' embeddings linearly
    interpolated over the (masked) latent length, plus an MLP of the
    absolute position.
  * ``DurationPredictor``: latents projected onto the audio stream, the
    character embeddings on the text stream, zeros on the frames stream,
    the tri-stream backbone at time 0, a masked mean over the valid frames
    and a softplus scalar head in float32: the predicted length in latent
    frames. ``loss`` is the MSE against the true lengths over a random
    prefix of each row, its uniform draw ``frac`` handed in or drawn from a
    ``torch.Generator``.

The backbone is the port's ``TriStreamTransformer``, so on a CUDA tensor in
bf16 its attentions run the packed flash forward (K1) and, under autograd,
the forward with lse and the backward (K3, K4, K5). No config of the
shipped model uses the predictor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from v2ap_torch.config import ModelConfig
from v2ap_torch.models.transformer import TriStreamTransformer
from v2ap_torch.ops.layers import Embed, Linear
from v2ap_torch.ops.sampling import lens_to_mask
from v2ap_torch.utils.device import resolve_device


class CharacterEmbed(nn.Module):
    def __init__(self, dim_text: int, num_embeds: int = 256, *, device=None):
        super().__init__()
        self.embed = Embed(num_embeds + 1, dim_text, device=device)

    def forward(self, tokens: torch.Tensor, length: int) -> torch.Tensor:
        tokens = tokens.long() + 1
        nt = tokens.shape[1]
        if nt >= length:
            tokens = tokens[:, :length]
        else:
            tokens = F.pad(tokens, (0, length - nt))
        return self.embed(tokens)


class InterpolatedCharacterEmbed(nn.Module):
    def __init__(self, dim_text: int, num_embeds: int = 256, *, device=None):
        super().__init__()
        self.embed = Embed(num_embeds, dim_text, device=device)
        self.pos_fc1 = Linear(1, dim_text, device=device)
        self.pos_fc2 = Linear(dim_text, dim_text, device=device)

    def forward(self, tokens: torch.Tensor, length: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (b, nt), -1 padded -> (b, length, dim_text); rows past
        ``mask`` are zero."""
        b = tokens.shape[0]
        dev = tokens.device
        valid = tokens >= 0
        counts = valid.sum(dim=1).clamp_min(1)                     # (b,)
        emb = self.embed(tokens.long().clamp_min(0))
        emb = torch.where(valid[..., None], emb, 0.0)
        audio_len = (mask.sum(dim=1) if mask is not None
                     else torch.full((b,), length, device=dev))
        out_idx = torch.arange(length, device=dev, dtype=torch.float32)[None]
        denom = (audio_len[:, None].float() - 1.0).clamp_min(1.0)
        last = (counts[:, None] - 1).float()
        src = torch.minimum((out_idx / denom * last).clamp_min(0.0), last)
        lo = torch.floor(src).long()
        hi = torch.minimum(lo + 1, counts[:, None] - 1)
        frac = (src - lo)[..., None]

        def gather(idx):
            return torch.gather(emb, 1, idx[..., None].expand(
                -1, -1, emb.shape[-1]))

        interp = gather(lo) * (1 - frac) + gather(hi) * frac
        abs_pos = out_idx / denom * counts[:, None].float()
        out = interp + self.pos_fc2(F.silu(self.pos_fc1(abs_pos[..., None])))
        if mask is not None:
            out = torch.where(mask[..., None], out, 0.0)
        return out


class DurationPredictor(nn.Module):
    def __init__(self, cfg: ModelConfig, text_num_embeds: int = 256, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        self.transformer = TriStreamTransformer(cfg, device=device)
        self.proj_in = Linear(cfg.num_channels, cfg.dim, dtype=dtype,
                              device=device)
        self.embed_text = CharacterEmbed(cfg.dim_text, text_num_embeds,
                                         device=device)
        self.to_pred = Linear(cfg.dim, 1, bias=False, dtype=dtype,
                              device=device)

    def _predict(self, latents, tokens, mask) -> torch.Tensor:
        b, n, _ = latents.shape
        x = self.proj_in(latents)
        text_embed = (self.embed_text(tokens, n) if tokens is not None
                      else x.new_zeros(b, n, self.cfg.dim_text))
        out = self.transformer(
            x, times=torch.zeros(b, device=x.device), mask=mask,
            text_embed=text_embed,
            frames_embed=x.new_zeros(b, n, self.cfg.dim_frames))
        out = torch.where(mask[..., None], out.float(), 0.0)
        pooled = out.sum(dim=1) / mask.sum(dim=1, keepdim=True).clamp_min(1)
        return F.softplus(self.to_pred(pooled)[:, 0].float())

    def forward(self, latents: torch.Tensor, tokens: Optional[torch.Tensor],
                lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """latents (b, n, C), tokens (b, nt) or None, lens (b,) or None ->
        predicted durations (b,) in latent frames, float32."""
        b, n, _ = latents.shape
        mask = (lens_to_mask(lens, n) if lens is not None
                else torch.ones(b, n, dtype=torch.bool,
                                device=latents.device))
        return self._predict(latents, tokens, mask)

    def loss(self, latents: torch.Tensor, tokens: Optional[torch.Tensor],
             lens: torch.Tensor, *, frac: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """MSE of the prediction from a random prefix of each row (the first
        ``int(frac * lens)`` frames, ``frac`` uniform in [0, 1) (b,),
        drawn from ``generator`` on its own device when not handed in)
        against the true lengths."""
        b, n, _ = latents.shape
        if frac is None:
            gen_dev = generator.device if generator is not None else "cpu"
            frac = torch.rand(b, generator=generator, device=gen_dev)
        frac = frac.to(device=latents.device, dtype=torch.float32)
        cut = (frac * lens.float()).to(torch.int32)
        mask = lens_to_mask(lens, n) & (
            torch.arange(n, device=latents.device)[None] < cut[:, None])
        pred = self._predict(latents, tokens, mask)
        return ((pred - lens.float()) ** 2).mean()
