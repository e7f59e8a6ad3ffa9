"""Readers of published encoder weights: plain state dicts under the
Hugging Face key names into the port's modules.

Counterpart of ``v2ap_tpu/utils/torch_convert.py``. The JAX package reads
``transformers`` modules (``.state_dict()``, ``.weight`` through torch's
weight-norm parametrization); the port reads the mapping of name to tensor
that a snapshot holds (``read_snapshot``), and imports neither
``transformers`` nor ``safetensors``:

  * ``load_encodec_state_dict``: ``facebook/encodec_24khz`` ->
    ``EncodecModel`` (convolutions with their weight norm folded from
    ``weight_g`` / ``weight_v`` or ``parametrizations.weight.original0/1``,
    the LSTMs, the RVQ codebooks);
  * ``load_t5_state_dict``: ``T5EncoderModel`` or
    ``T5ForConditionalGeneration`` (the encoder; the decoder's keys are left
    over) -> ``T5Encoder``;
  * ``load_clip_vision_state_dict``: ``CLIPVisionModelWithProjection`` ->
    ``CLIPVisionModel`` (ViT-bigG and ViT-L/336 alike);
  * ``load_dinov2_state_dict``: ``Dinov2Model`` -> ``Dinov2Model``, the
    position table resized to the serving grid as JAX resizes it;
  * ``load_convnext_state_dict``: ``ConvNextModel`` (optionally under
    ``convnext.``) and open_clip's ``mlp.fc*`` head -> ``ConvNextCLIP``;
  * ``load_video2roll_state_dict``: Audeo's ``Video2RollNet.resnet18`` ->
    ``Video2RollNet``;
  * ``load_vocos_from_state_dict``: charactr/vocos-mel-24khz -> ``Vocos``;
  * ``load_ldm_unet_from_state_dict``: the AudioLDM UNet's subtree of a
    checkpoint (``model.diffusion_model.*`` of audioldm-s-full) ->
    ``UNet2D``, its 1x1 convolutions into the port's ``Conv1x1`` /
    ``Linear`` weights (out, in).

The port's ``Linear`` and convolutions keep PyTorch's layouts, so tensors
copy as they are, in the destination's dtype. Every reader raises on a
missing key or a shape that does not fit, raises if a port tensor is left
unfilled, and returns the sorted keys it did not consume.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Mapping, Optional

import torch
from torch import nn

# safetensors dtype names -> torch dtypes
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


# --------------------------------------------------------------- snapshots

def read_safetensors(path: str) -> dict:
    """The tensors of one ``.safetensors`` file, read without the
    ``safetensors`` package: an 8-byte little-endian header length, a JSON
    header of name -> {dtype, shape, data_offsets}, then the raw buffers,
    which become tensors over a copy-on-write memory map (nothing is read
    until a tensor is used)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if os.fstat(f.fileno()).st_size > 8 + n else b"")
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, "
                             f"which is not supported")
        shape = tuple(meta["shape"])
        begin, end = meta["data_offsets"]
        count = math.prod(shape)
        if end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: {name} holds {end - begin} bytes, "
                             f"not {count} x {dtype}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                     offset=8 + n + begin).view(shape)
    return out


def read_snapshot(path: str) -> dict:
    """The state dict of a Hugging Face snapshot directory on disk (what
    ``from_pretrained(path)`` would read): ``model.safetensors``, sharded
    ``model-*.safetensors`` named by ``model.safetensors.index.json``, or
    ``pytorch_model.bin`` (sharded with its ``.index.json``), the last
    through ``torch.load(weights_only=True, mmap=True)``. ``path`` may also
    name one such file."""
    def load(file: str) -> dict:
        if file.endswith(".safetensors"):
            return read_safetensors(file)
        return dict(torch.load(file, map_location="cpu", weights_only=True,
                               mmap=True))

    if os.path.isfile(path):
        return load(path)
    for single in ("model.safetensors", "pytorch_model.bin"):
        index = f"{single}.index.json"
        if os.path.isfile(os.path.join(path, single)):
            return load(os.path.join(path, single))
        if os.path.isfile(os.path.join(path, index)):
            with open(os.path.join(path, index)) as f:
                weight_map = json.load(f)["weight_map"]
            out = {}
            for shard in sorted(set(weight_map.values())):
                out.update(load(os.path.join(path, shard)))
            missing = sorted(set(weight_map) - set(out))
            if missing:
                raise KeyError(f"{path}: the index names tensors its shards "
                               f"lack: {missing[:5]}")
            return out
    raise FileNotFoundError(f"{path}: no model.safetensors, sharded "
                            f"safetensors or pytorch_model.bin")


# ------------------------------------------------------------------ filling

class _Filler:
    """Copies named source tensors into a module's tensors, keeping count of
    the keys consumed and the tensors filled."""

    def __init__(self, sd: Mapping, model: nn.Module):
        self.sd = sd
        self.tensors = dict(model.named_parameters())
        self.tensors.update(model.named_buffers())
        self.used: set = set()
        self.filled: set = set()

    def has(self, key: str) -> bool:
        return key in self.sd

    def take(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise KeyError(f"state dict has no {key!r}")
        self.used.add(key)
        return self.sd[key]

    def put(self, name: str, value: torch.Tensor, key: str = "") -> None:
        dst = self.tensors[name]
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"{key or name}: shape {tuple(value.shape)} does "
                             f"not fit {name} {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(value)
        self.filled.add(name)

    def copy(self, name: str, key: str) -> None:
        self.put(name, self.take(key), key)

    def pair(self, dst: str, src: str, leaves=("weight", "bias")) -> None:
        """``src.<leaf>`` into ``dst.<leaf>`` for each leaf."""
        for leaf in leaves:
            self.copy(f"{dst}.{leaf}", f"{src}.{leaf}")

    def done(self, optional: tuple = ()) -> list:
        """Raise if a port tensor other than those under ``optional`` was
        left unfilled; return the keys not consumed."""
        missing = sorted(n for n in set(self.tensors) - self.filled
                         if not n.startswith(optional))
        if missing:
            raise KeyError(f"port tensors not filled: {missing[:8]}"
                           f"{' ...' if len(missing) > 8 else ''}")
        return sorted(set(self.sd) - self.used)


def _weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``torch._weight_norm(v, g, dim=0)``: v scaled per slice of its first
    axis to the norm g, in float32 (the first axis is the output of a
    convolution and the input of a transposed one, as torch's weight norm
    takes it for both)."""
    v = v.float()
    norm = torch.linalg.vector_norm(v, dim=tuple(range(1, v.ndim)),
                                    keepdim=True)
    return v * (g.float() / norm)


# --------------------------------------------------------------------- encodec

def _codec_weight(f: _Filler, key: str) -> tuple:
    """(folded weight, its key) of the EnCodec convolution ``key``."""
    p = f"{key}.parametrizations.weight"
    if f.has(f"{p}.original0"):
        return _weight_norm(f.take(f"{p}.original1"),
                            f.take(f"{p}.original0")), f"{p}.original1"
    if f.has(f"{key}.weight_g"):
        return _weight_norm(f.take(f"{key}.weight_v"),
                            f.take(f"{key}.weight_g")), f"{key}.weight_v"
    return f.take(f"{key}.weight"), f"{key}.weight"


def load_encodec_state_dict(sd: Mapping, model: nn.Module) -> list:
    """An HF ``EncodecModel`` state dict into the port's ``EncodecModel``.
    The quantizer's codebooks (``quantizer.layers.<q>.codebook.embed``) are
    read when the state dict has a quantizer, the first
    ``num_quantizers`` of them, as JAX reads them; the codebooks' EMA
    statistics are left over."""
    from v2ap_torch.models.encodec import (CausalConv1d, CausalConvTranspose1d,
                                           ResidualLSTM, ResnetBlock1d)

    f = _Filler(sd, model)

    def conv(dst: str, src: str) -> None:
        w, key = _codec_weight(f, f"{src}.conv")
        f.put(f"{dst}.weight", w, key)
        f.copy(f"{dst}.bias", f"{src}.conv.bias")

    for part in ("encoder", "decoder"):
        for i, layer in enumerate(getattr(model, part).layers):
            dst, src = f"{part}.layers.{i}", f"{part}.layers.{i}"
            if isinstance(layer, (CausalConv1d, CausalConvTranspose1d)):
                conv(dst, src)
            elif isinstance(layer, ResnetBlock1d):
                # HF's block interleaves ELUs: its convolutions are 1, 3, ...
                for j in range(len(layer.block)):
                    conv(f"{dst}.block.{j}", f"{src}.block.{2 * j + 1}")
                conv(f"{dst}.shortcut", f"{src}.shortcut")
            elif isinstance(layer, ResidualLSTM):
                for leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    for n in range(layer.lstm.num_layers):
                        f.copy(f"{dst}.lstm.{leaf}_l{n}",
                               f"{src}.lstm.{leaf}_l{n}")
    q = model.quantizer.codebooks.shape[0]
    if f.has("quantizer.layers.0.codebook.embed"):
        books = [f.take(f"quantizer.layers.{i}.codebook.embed")
                 for i in range(q)]
        f.put("quantizer.codebooks", torch.stack(books), "quantizer.layers")
        # the codebooks past the port's count and the EMA statistics
        for key in list(sd):
            if key.startswith("quantizer.layers."):
                f.used.add(key)
        return f.done()
    return f.done(optional=("quantizer.",))


# ------------------------------------------------------------------------ t5

def load_t5_state_dict(sd: Mapping, model: nn.Module) -> list:
    """An HF ``T5EncoderModel`` (or ``T5ForConditionalGeneration``) state
    dict into ``T5Encoder``. ``encoder.embed_tokens.weight``, the tied copy
    of ``shared.weight``, is consumed when present."""
    f = _Filler(sd, model)
    f.copy("embed.weight", "shared.weight")
    if f.has("encoder.embed_tokens.weight"):
        f.take("encoder.embed_tokens.weight")
    for i, blk in enumerate(model.blocks):
        d, p = f"blocks.{i}", f"encoder.block.{i}.layer"
        for name in ("q", "k", "v", "o"):
            f.copy(f"{d}.attn.{name}.weight",
                   f"{p}.0.SelfAttention.{name}.weight")
        f.copy(f"{d}.ln1.weight", f"{p}.0.layer_norm.weight")
        if blk.attn.rel_bias is not None:
            f.copy(f"{d}.attn.rel_bias.weight",
                   f"{p}.0.SelfAttention.relative_attention_bias.weight")
        ffs = ("wi_0", "wi_1", "wo") if blk.ff.gated else ("wi", "wo")
        for name in ffs:
            f.copy(f"{d}.ff.{name}.weight",
                   f"{p}.1.DenseReluDense.{name}.weight")
        f.copy(f"{d}.ln2.weight", f"{p}.1.layer_norm.weight")
    f.copy("final_ln.weight", "encoder.final_layer_norm.weight")
    return f.done()


# ---------------------------------------------------------------------- clip

def load_clip_vision_state_dict(sd: Mapping, model: nn.Module) -> list:
    """An HF ``CLIPVisionModelWithProjection`` state dict into
    ``CLIPVisionModel`` (the pre-layernorm under either spelling,
    ``pre_layrnorm`` or ``pre_layernorm``)."""
    f = _Filler(sd, model)
    v = "vision_model"
    f.copy("patch_embed.weight", f"{v}.embeddings.patch_embedding.weight")
    f.copy("class_embedding", f"{v}.embeddings.class_embedding")
    f.copy("position_embedding", f"{v}.embeddings.position_embedding.weight")
    pre = (f"{v}.pre_layrnorm" if f.has(f"{v}.pre_layrnorm.weight")
           else f"{v}.pre_layernorm")
    f.pair("pre_layernorm", pre)
    for i in range(len(model.blocks)):
        d, p = f"blocks.{i}", f"{v}.encoder.layers.{i}"
        for src, dst in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                         ("out_proj", "o")):
            f.pair(f"{d}.attn.{dst}", f"{p}.self_attn.{src}")
        f.pair(f"{d}.ln1", f"{p}.layer_norm1")
        f.pair(f"{d}.ln2", f"{p}.layer_norm2")
        f.pair(f"{d}.mlp.fc1", f"{p}.mlp.fc1")
        f.pair(f"{d}.mlp.fc2", f"{p}.mlp.fc2")
    f.pair("post_layernorm", f"{v}.post_layernorm")
    f.copy("visual_projection.weight", "visual_projection.weight")
    return f.done()


# -------------------------------------------------------------------- dinov2

def resize_position_grid(pos: torch.Tensor, n_dst: int) -> torch.Tensor:
    """A (1 + g*g, d) position table with its patch grid resized to
    (1 + n_dst) rows by JAX's bicubic resize (``jax.image.resize``, which
    the JAX reader calls; antialiased when shrinking), the class row kept."""
    from v2ap_torch.models.clap import bicubic_matrix

    n_src = pos.shape[0] - 1
    if n_src == n_dst:
        return pos
    g_src, g_dst = round(n_src ** 0.5), round(n_dst ** 0.5)
    w = torch.from_numpy(bicubic_matrix(g_src, g_dst)).to(pos.device)
    grid = pos[1:].float().reshape(g_src, g_src, -1)
    grid = torch.einsum("ia,jb,ijd->abd", w, w, grid)
    return torch.cat([pos[:1].float(), grid.reshape(g_dst * g_dst, -1)])


def load_dinov2_state_dict(sd: Mapping, model: nn.Module) -> list:
    """An HF ``Dinov2Model`` state dict into ``Dinov2Model``: the SwiGLU
    ``weights_in`` / ``weights_out`` of the giant variant or the MLP's
    ``fc1`` / ``fc2``; a checkpoint trained at another resolution (giant
    ships 518 px, a 37 x 37 grid) has its position table resized to the
    port's grid."""
    f = _Filler(sd, model)
    e = "embeddings"
    f.copy("patch_embed.weight", f"{e}.patch_embeddings.projection.weight")
    f.copy("patch_embed.bias", f"{e}.patch_embeddings.projection.bias")
    f.put("cls_token", f.take(f"{e}.cls_token")[0, 0], f"{e}.cls_token")
    pos = f.take(f"{e}.position_embeddings")[0]
    n_dst = model.position_embedding.shape[0] - 1
    f.put("position_embedding", resize_position_grid(pos, n_dst),
          f"{e}.position_embeddings")
    if f.has(f"{e}.mask_token"):
        f.take(f"{e}.mask_token")          # masked-image pretraining only
    for i in range(len(model.blocks)):
        d, p = f"blocks.{i}", f"encoder.layer.{i}"
        for src, dst in (("query", "q"), ("key", "k"), ("value", "v")):
            f.pair(f"{d}.attn.{dst}", f"{p}.attention.attention.{src}")
        f.pair(f"{d}.attn.o", f"{p}.attention.output.dense")
        f.pair(f"{d}.norm1", f"{p}.norm1")
        f.pair(f"{d}.norm2", f"{p}.norm2")
        f.copy(f"{d}.scale1", f"{p}.layer_scale1.lambda1")
        f.copy(f"{d}.scale2", f"{p}.layer_scale2.lambda1")
        names = (("weights_in", "weights_out")
                 if f.has(f"{p}.mlp.weights_in.weight") else ("fc1", "fc2"))
        for name in names:
            f.pair(f"{d}.mlp.{name}", f"{p}.mlp.{name}")
    f.pair("layernorm", "layernorm")
    return f.done()


# ------------------------------------------------------------------ convnext

def load_convnext_state_dict(sd: Mapping, model: nn.Module,
                             head_state: Optional[Mapping] = None) -> list:
    """An HF ``ConvNextModel`` state dict (keys optionally under
    ``convnext.``, as in ``ConvNextForImageClassification``) into the trunk
    of ``ConvNextCLIP``; ``head_state`` optionally carries open_clip's
    projection head (``mlp.fc1.weight`` ... ``mlp.fc2.bias``, the
    ``visual.head.*`` tensors). Without it the head is not filled."""
    f = _Filler(sd, model)
    pre = "convnext." if any(k.startswith("convnext.") for k in sd) else ""
    f.pair("stem_conv", f"{pre}embeddings.patch_embeddings")
    f.pair("stem_norm", f"{pre}embeddings.layernorm")
    for s, stage in enumerate(model.stages):
        if s > 0:
            ds = f"{pre}encoder.stages.{s}.downsampling_layer"
            f.pair(f"downsamples.{s - 1}.norm", f"{ds}.0")
            f.pair(f"downsamples.{s - 1}.conv", f"{ds}.1")
        for i in range(len(stage)):
            d, p = f"stages.{s}.{i}", f"{pre}encoder.stages.{s}.layers.{i}"
            f.pair(f"{d}.dwconv", f"{p}.dwconv")
            f.pair(f"{d}.norm", f"{p}.layernorm")
            f.pair(f"{d}.pwconv1", f"{p}.pwconv1")
            f.pair(f"{d}.pwconv2", f"{p}.pwconv2")
            f.copy(f"{d}.scale", f"{p}.layer_scale_parameter")
    f.pair("head_norm", f"{pre}layernorm")
    left = f.done(optional=("head_fc1.", "head_fc2."))
    if head_state:
        h = _Filler(head_state, model)
        h.pair("head_fc1", "mlp.fc1")
        h.pair("head_fc2", "mlp.fc2")
        left += [f"head:{k}" for k in sorted(set(head_state) - h.used)]
    return left


# ----------------------------------------------------------------- video2roll

def load_video2roll_state_dict(sd: Mapping, model: nn.Module) -> list:
    """Audeo's ``Video2RollNet.resnet18`` state dict into ``Video2RollNet``:
    convolutions, BatchNorms (their ``num_batches_tracked`` counters are
    consumed), the FTB / FRB blocks, ``toplayer``, ``conv2`` and ``fc``."""
    f = _Filler(sd, model)

    def conv(dst: str, src: str) -> None:
        f.copy(f"{dst}.weight", f"{src}.weight")
        if f"{dst}.bias" in f.tensors:
            f.copy(f"{dst}.bias", f"{src}.bias")

    def bn(dst: str, src: str) -> None:
        f.pair(dst, src, ("weight", "bias", "running_mean", "running_var"))
        if f.has(f"{src}.num_batches_tracked"):
            f.take(f"{src}.num_batches_tracked")

    def convbn(dst: str, conv_key: str, bn_key: str) -> None:
        conv(f"{dst}.conv", conv_key)
        bn(f"{dst}.bn", bn_key)

    convbn("stem", "conv1", "bn1")
    for li in range(1, 5):
        for bi, blk in enumerate(getattr(model, f"layer{li}")):
            d, p = f"layer{li}.{bi}", f"layer{li}.{bi}"
            convbn(f"{d}.cb1", f"{p}.conv1", f"{p}.bn1")
            convbn(f"{d}.cb2", f"{p}.conv2", f"{p}.bn2")
            if blk.down is not None:
                convbn(f"{d}.down", f"{p}.downsample.0", f"{p}.downsample.1")
    for dst, src in (("ftb2_1", "FTB2_1"), ("ftb2_2", "FTB2_2"),
                     ("ftb3", "FTB3"), ("ftb4", "FTB4")):
        conv(f"{dst}.conv0", f"{src}.conv0")
        convbn(f"{dst}.cb1", f"{src}.conv1", f"{src}.bn1")
        conv(f"{dst}.conv2", f"{src}.conv2")
    for dst, src in (("frb2", "FRB2"), ("frb3", "FRB3"), ("frb4", "FRB4")):
        f.pair(f"{dst}.fc1", f"{src}.fc1")
        f.pair(f"{dst}.fc2", f"{src}.fc2")
    convbn("toplayer", "toplayer", "toplayer_bn")
    conv("conv2", "conv2")
    f.pair("fc", "fc")
    return f.done()


# --------------------------------------------------------------------- vocos

def load_vocos_from_state_dict(sd: Mapping, model: nn.Module) -> list:
    """A charactr/vocos-mel-24khz state dict into ``Vocos`` (the keys the
    JAX package's reader takes; the feature extractor's mel filters and the
    ISTFT head's window are left over)."""
    f = _Filler(sd, model)
    f.pair("embed", "backbone.embed")
    f.pair("norm", "backbone.norm")
    for i in range(len(model.blocks)):
        d, p = f"blocks.{i}", f"backbone.convnext.{i}"
        for name in ("dwconv", "norm", "pwconv1", "pwconv2"):
            f.pair(f"{d}.{name}", f"{p}.{name}")
        f.copy(f"{d}.gamma", f"{p}.gamma")
    f.pair("final_norm", "backbone.final_layer_norm")
    f.pair("head", "head.out")
    return f.done()


# ------------------------------------------------------------------ ldm unet

def load_ldm_unet_from_state_dict(state_dict: Mapping, unet: nn.Module,
                                  prefix: str = "") -> list:
    """An AudioLDM UNet state dict in the reference's key layout, the keys
    under ``prefix`` (``"model.diffusion_model."`` for a whole audioldm-s-full
    checkpoint), into ``UNet2D``. q / k / v projections are bias-free: a
    bias given for them is left over, as the JAX reader ignores it. Returns
    the keys under ``prefix`` left over (with the prefix); keys outside it
    are not looked at."""
    from v2ap_torch.models import latent_diffusion as ldm

    sd = {k[len(prefix):]: v for k, v in state_dict.items()
          if k.startswith(prefix)}
    f = _Filler(sd, unet)

    def lin(dst: str, key: str) -> None:
        f.copy(f"{dst}.weight", f"{key}.weight")
        if f"{dst}.bias" in f.tensors:
            f.copy(f"{dst}.bias", f"{key}.bias")

    def conv1x1(dst: str, key: str) -> None:
        f.put(f"{dst}.weight", f.take(f"{key}.weight")[:, :, 0, 0],
              f"{key}.weight")
        f.copy(f"{dst}.bias", f"{key}.bias")

    def layer(mod: nn.Module, dst: str, key: str) -> None:
        if isinstance(mod, ldm.ResBlock):
            f.pair(f"{dst}.norm1", f"{key}.in_layers.0")
            f.pair(f"{dst}.conv1", f"{key}.in_layers.2")
            lin(f"{dst}.emb", f"{key}.emb_layers.1")
            f.pair(f"{dst}.norm2", f"{key}.out_layers.0")
            f.pair(f"{dst}.conv2", f"{key}.out_layers.3")
            if mod.skip is not None:
                conv1x1(f"{dst}.skip", f"{key}.skip_connection")
        elif isinstance(mod, ldm.SpatialTransformer):
            f.pair(f"{dst}.norm", f"{key}.norm")
            conv1x1(f"{dst}.proj_in", f"{key}.proj_in")
            conv1x1(f"{dst}.proj_out", f"{key}.proj_out")
            for t in range(len(mod.blocks)):
                d, k = f"{dst}.blocks.{t}", f"{key}.transformer_blocks.{t}"
                for nm in ("norm1", "norm2", "norm3"):
                    f.pair(f"{d}.{nm}", f"{k}.{nm}")
                for at in ("attn1", "attn2"):
                    for proj in ("to_q", "to_k", "to_v"):
                        lin(f"{d}.{at}.{proj}", f"{k}.{at}.{proj}")
                    lin(f"{d}.{at}.to_out", f"{k}.{at}.to_out.0")
                lin(f"{d}.ff.proj", f"{k}.ff.net.0.proj")
                lin(f"{d}.ff.out", f"{k}.ff.net.2")
        elif isinstance(mod, ldm.Downsample):
            f.pair(f"{dst}.conv", f"{key}.op")
        elif isinstance(mod, ldm.Upsample):
            f.pair(f"{dst}.conv", f"{key}.conv")

    def block(blk: nn.Module, dst: str, key: str) -> None:
        for j, mod in enumerate(blk.layers):
            layer(mod, f"{dst}.layers.{j}", f"{key}.{j}")

    lin("time_dense1", "time_embed.0")
    lin("time_dense2", "time_embed.2")
    if unet.cfg.film_dim:
        lin("film_emb", "film_emb")
    f.pair("conv_in", "input_blocks.0.0")
    for i, blk in enumerate(unet.input_blocks):
        block(blk, f"input_blocks.{i}", f"input_blocks.{i + 1}")
    block(unet.middle_block, "middle_block", "middle_block")
    for i, blk in enumerate(unet.output_blocks):
        block(blk, f"output_blocks.{i}", f"output_blocks.{i}")
    f.pair("norm_out", "out.0")
    f.pair("conv_out", "out.2")
    return [prefix + k for k in f.done()]
