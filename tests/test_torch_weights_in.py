"""Published weights into the port (``v2ap_torch/utils/torch_convert.py``,
``python -m v2ap_torch.convert``) against Hugging Face's modules and the
JAX package's readers, on the CPU in float32.

Each reader gets the state dict of a Hugging Face module built from a tiny
config with random weights (no download), as the JAX package's own encoder
tests build theirs; the JAX reader reads the same module. Video2Roll's
torch module is the reference's, which is not in the repository: its
reader gets a synthetic state dict under the reference's key names, the
JAX reader the same through a shim with ``state_dict()``.

Tolerances: the port's output against HF's within 2e-4 absolute (f32,
another summation order); the port's parameters equal to the ones the JAX
reader gives, carried across by ``load_jax_params`` (exactly; folded weight
norms and a resized position table within 1e-6); outputs against JAX's
within 1e-5 relative RMS. The full-width key lists (``tests/golden/
hf_keys_*.json``, read by ``chip_smoke.py``) are re-derived from the HF
modules built on the meta device at the port's full-size configs.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax
from v2ap_torch import convert as t_convert
from v2ap_torch.models import clip_vit as t_clip
from v2ap_torch.models import convnext as t_convnext
from v2ap_torch.models import dinov2 as t_dinov2
from v2ap_torch.models import encodec as t_encodec
from v2ap_torch.models import t5 as t_t5
from v2ap_torch.models import video2roll as t_v2r
from v2ap_torch.utils import torch_convert as tc
from v2ap_torch.utils.convert import load_jax_params
from v2ap_torch.utils.jitting import create_model_zeros
from v2ap_tpu.models import clip_vit as j_clip
from v2ap_tpu.models import convnext as j_convnext
from v2ap_tpu.models import dinov2 as j_dinov2
from v2ap_tpu.models import encodec as j_encodec
from v2ap_tpu.models import t5 as j_t5
from v2ap_tpu.models import video2roll as j_v2r
from v2ap_tpu.utils import torch_convert as jc

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

HF_ATOL = 2e-4
JAX_REL_RMS = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _randomize(module: torch.nn.Module, seed: int) -> None:
    """Every floating tensor of an HF module redrawn from ``seed`` (biases,
    LayerNorms and codebooks away from their 0 / 1 initialisation), kept
    small enough for deep stacks to stay finite."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif t.ndim >= 2:
                t.copy_(torch.randn(t.shape, generator=gen)
                        / np.sqrt(max(1, t[0].numel())))
            else:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1
                        + (1.0 if name.endswith(("norm.weight", "norm1.weight",
                                                 "norm2.weight")) else 0.0))


def _via_jax(jm, factory) -> torch.nn.Module:
    """A port module holding the JAX model's parameters."""
    tm = create_model_zeros(factory)
    load_jax_params(tm, flatten_jax(jm))
    return tm


def _same_params(got: torch.nn.Module, want: torch.nn.Module,
                 close=()) -> None:
    """Every tensor equal, those whose names contain one of ``close``
    within 1e-6."""
    w = want.state_dict()
    for name, t in got.state_dict().items():
        if any(c in name for c in close):
            torch.testing.assert_close(t, w[name], rtol=1e-6, atol=1e-6,
                                       msg=name)
        else:
            assert torch.equal(t, w[name]), name


# --------------------------------------------------------------------- encodec

def _hf_encodec(seed: int = 0, **kw):
    from transformers import EncodecConfig, EncodecModel

    hf_cfg = EncodecConfig(num_filters=4, hidden_size=8,
                           upsampling_ratios=[4, 2], num_lstm_layers=1,
                           codebook_size=16, target_bandwidths=[60.0], **kw)
    torch.manual_seed(seed)
    model = EncodecModel(hf_cfg).eval()
    _randomize(model.quantizer, seed + 1)
    return model


def _weight_g_form(sd: dict) -> dict:
    """``parametrizations.weight.original0/1`` renamed to the published
    files' ``weight_g`` / ``weight_v``."""
    out = {}
    for k, v in sd.items():
        k = (k.replace("parametrizations.weight.original0", "weight_g")
             .replace("parametrizations.weight.original1", "weight_v"))
        out[k] = v
    return out


def _tiny_codec_cfg(mod):
    return mod.EncodecConfig(num_filters=4, hidden_size=8,
                             upsampling_ratios=(4, 2), num_lstm_layers=1,
                             num_quantizers=2, codebook_size=16)


@pytest.mark.parametrize("form", ["parametrizations", "weight_g"])
def test_encodec_reader_matches_hf_and_jax(form):
    """Both weight-norm key forms fold to HF's weights (and to
    ``torch._weight_norm``); the encoder, decoder and the two codebooks
    match HF's module and JAX's reader."""
    hf = _hf_encodec(0)
    sd = hf.state_dict()
    if form == "weight_g":
        sd = _weight_g_form(sd)
    factory = lambda d: t_encodec.EncodecModel(_tiny_codec_cfg(t_encodec),
                                               device=d)
    tm = create_model_zeros(factory)
    left = tc.load_encodec_state_dict(sd, tm)
    assert left == []
    conv = hf.encoder.layers[3].conv
    torch.testing.assert_close(tm.encoder.layers[3].weight, conv.weight,
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(
        tm.decoder.layers[3].weight,          # transposed: (in, out, k)
        torch._weight_norm(hf.decoder.layers[3].conv.parametrizations.weight
                           .original1, hf.decoder.layers[3].conv
                           .parametrizations.weight.original0, 0),
        rtol=1e-6, atol=1e-7)
    jm = j_encodec.EncodecModel(_tiny_codec_cfg(j_encodec), rngs=nnx.Rngs(0))
    jc.load_encodec_from_torch(hf, jm)
    _same_params(tm, _via_jax(jm, factory), close=("weight",))

    wav = (np.random.default_rng(1).normal(size=(1, 800)) * 0.3
           ).astype(np.float32)
    with torch.no_grad():
        lat = tm.encode(T(wav))
        hf_lat = hf.encoder(T(wav)[:, None])
        np.testing.assert_allclose(N(lat), N(hf_lat.transpose(1, 2)),
                                   atol=HF_ATOL, rtol=0)
        out = tm.decode(lat)
        np.testing.assert_allclose(N(out), N(hf.decoder(hf_lat)[:, 0]),
                                   atol=HF_ATOL, rtol=0)
        codes = tm.quantizer.encode(lat, 2)
    want_lat = np.asarray(nnx.jit(lambda m, w: m.encode(w))(
        jm, jnp.asarray(wav)))
    assert rel_rms(N(lat), want_lat) < JAX_REL_RMS
    hf_codes = hf.quantizer.encode(hf_lat, bandwidth=60.0)
    np.testing.assert_array_equal(N(codes), N(hf_codes)[:2])


def test_encodec_reader_without_a_quantizer_and_its_checks():
    """A state dict without the quantizer (HF's config with no codebooks, as
    JAX's test builds it) leaves the codebooks alone; a missing key or a
    shape that does not fit raises."""
    from transformers import EncodecConfig, EncodecModel

    hf = EncodecModel(EncodecConfig(num_filters=4, hidden_size=8,
                                    upsampling_ratios=[4, 2],
                                    num_lstm_layers=1, codebook_size=16,
                                    target_bandwidths=[0.5])).eval()
    sd = hf.state_dict()
    tm = t_encodec.EncodecModel(_tiny_codec_cfg(t_encodec), device="cpu")
    books = tm.quantizer.codebooks.detach().clone()
    assert tc.load_encodec_state_dict(sd, tm) == []
    assert torch.equal(tm.quantizer.codebooks, books)
    key = "decoder.layers.9.conv.bias"
    with pytest.raises(KeyError, match=key):
        tc.load_encodec_state_dict({k: v for k, v in sd.items() if k != key},
                                   tm)
    with pytest.raises(ValueError, match="does not fit"):
        tc.load_encodec_state_dict({**sd, key: torch.zeros(2)}, tm)


# ------------------------------------------------------------------------ t5

def _hf_t5_cfg():
    from transformers import T5Config

    cfg = t_t5.t5_tiny_test()
    return T5Config(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                    d_kv=cfg.d_kv, d_ff=cfg.d_ff, num_layers=cfg.num_layers,
                    num_decoder_layers=1, num_heads=cfg.num_heads,
                    relative_attention_num_buckets=
                    cfg.relative_attention_num_buckets,
                    relative_attention_max_distance=
                    cfg.relative_attention_max_distance,
                    feed_forward_proj="gated-gelu", dropout_rate=0.0)


@pytest.mark.parametrize("kind", ["encoder", "conditional"])
def test_t5_reader_matches_hf_and_jax(kind):
    """``T5EncoderModel`` and ``T5ForConditionalGeneration`` (what a FLAN-T5
    snapshot holds: the decoder's keys are left over)."""
    from transformers import T5EncoderModel, T5ForConditionalGeneration

    torch.manual_seed(0)
    cls = T5EncoderModel if kind == "encoder" else T5ForConditionalGeneration
    hf = cls(_hf_t5_cfg()).eval()
    _randomize(hf, 1)
    factory = lambda d: t_t5.T5Encoder(t_t5.t5_tiny_test(), device=d)
    tm = create_model_zeros(factory)
    left = tc.load_t5_state_dict(hf.state_dict(), tm)
    if kind == "encoder":
        assert left == []
    else:
        assert left and all(k.startswith(("decoder.", "lm_head."))
                            for k in left)
    ids = np.asarray([[3, 9, 2, 7, 1, 0]], np.int64)
    mask = np.asarray([[1, 1, 1, 1, 1, 0]], np.int64)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask))
        enc = hf if kind == "encoder" else hf.encoder
        want = enc(input_ids=torch.from_numpy(ids),
                   attention_mask=torch.from_numpy(mask))[0]
    np.testing.assert_allclose(N(got)[0, :5], N(want)[0, :5], atol=HF_ATOL,
                               rtol=0)
    if kind == "encoder":
        jm = j_t5.T5Encoder(j_t5.t5_tiny_test(), rngs=nnx.Rngs(0))
        jc.load_t5_from_torch(hf, jm)
        _same_params(tm, _via_jax(jm, factory))
        j_out = np.asarray(jm(jnp.asarray(ids, jnp.int32),
                              jnp.asarray(mask, jnp.int32)))
        assert rel_rms(N(got), j_out) < JAX_REL_RMS


# ---------------------------------------------------------------------- clip

def _clip_cfg(mod, act: str):
    return dataclasses.replace(mod.clip_tiny_test(), hidden_act=act)


@pytest.mark.parametrize("act,pre", [("gelu", "pre_layrnorm"),
                                     ("quick_gelu", "pre_layernorm")],
                         ids=["bigG_gelu", "L336_quick_gelu"])
def test_clip_reader_matches_hf_and_jax(act, pre):
    """``CLIPVisionModelWithProjection`` into ``CLIPVisionModel`` (GELU as
    ViT-bigG, quick GELU as ViT-L/336), either pre-layernorm spelling."""
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    cfg = _clip_cfg(t_clip, act)
    torch.manual_seed(0)
    hf = CLIPVisionModelWithProjection(CLIPVisionConfig(
        hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        projection_dim=cfg.projection_dim, hidden_act=act,
        attention_dropout=0.0)).eval()
    _randomize(hf, 2)
    sd = {k.replace("pre_layrnorm", pre): v
          for k, v in hf.state_dict().items()}
    factory = lambda d: t_clip.CLIPVisionModel(cfg, device=d)
    tm = create_model_zeros(factory)
    assert tc.load_clip_vision_state_dict(sd, tm) == []
    px = np.random.default_rng(0).normal(
        size=(2, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    with torch.no_grad():
        got = tm(T(px.transpose(0, 2, 3, 1)))
        want = hf(pixel_values=T(px)).image_embeds
    np.testing.assert_allclose(N(got), N(want), atol=HF_ATOL, rtol=0)
    jm = j_clip.CLIPVisionModel(_clip_cfg(j_clip, act), rngs=nnx.Rngs(0))
    jc.load_clip_vision_from_torch(hf, jm)
    _same_params(tm, _via_jax(jm, factory))
    j_out = np.asarray(nnx.jit(lambda m, v: m(v))(
        jm, jnp.asarray(px.transpose(0, 2, 3, 1))))
    assert rel_rms(N(got), j_out) < JAX_REL_RMS


# -------------------------------------------------------------------- dinov2

def _hf_dinov2(cfg, image_size: int, seed: int):
    from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(seed)
    hf = Dinov2Model(Dinov2Config(
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
        use_swiglu_ffn=cfg.use_swiglu_ffn, image_size=image_size,
        patch_size=cfg.patch_size, layerscale_value=cfg.layerscale_value,
        layer_norm_eps=cfg.layer_norm_eps, hidden_act="gelu",
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
        drop_path_rate=0.0)).eval()
    _randomize(hf, seed + 1)
    return hf


@pytest.mark.parametrize("swiglu,hf_size", [(True, 28), (False, 28),
                                            (True, 70)],
                         ids=["swiglu", "mlp", "resized_positions"])
def test_dinov2_reader_matches_hf_and_jax(swiglu, hf_size):
    """SwiGLU (giant) and MLP feed-forwards; a checkpoint at 70 px (a 5 x 5
    grid, as giant ships 518 px) has its position table resized to the
    port's 2 x 2 grid as JAX's reader resizes it (HF interpolates at run
    time instead, so only JAX is the reference there)."""
    cfg = dataclasses.replace(t_dinov2.dinov2_tiny_test(),
                              use_swiglu_ffn=swiglu)
    hf = _hf_dinov2(cfg, hf_size, 3)
    factory = lambda d: t_dinov2.Dinov2Model(cfg, device=d)
    tm = create_model_zeros(factory)
    assert tc.load_dinov2_state_dict(hf.state_dict(), tm) == []
    px = np.random.default_rng(0).normal(size=(2, 3, 28, 28)
                                         ).astype(np.float32)
    with torch.no_grad():
        got = tm(T(px.transpose(0, 2, 3, 1)))
        if hf_size == 28:
            want = hf(pixel_values=T(px)).pooler_output
            np.testing.assert_allclose(N(got), N(want), atol=HF_ATOL, rtol=0)
    jcfg = dataclasses.replace(j_dinov2.dinov2_tiny_test(),
                               use_swiglu_ffn=swiglu)
    jm = j_dinov2.Dinov2Model(jcfg, rngs=nnx.Rngs(0))
    jc.load_dinov2_from_torch(hf, jm)
    _same_params(tm, _via_jax(jm, factory), close=("position_embedding",))
    j_out = np.asarray(jm(jnp.asarray(px.transpose(0, 2, 3, 1))))
    assert rel_rms(N(got), j_out) < JAX_REL_RMS


# ------------------------------------------------------------------ convnext

@pytest.mark.parametrize("prefixed", [False, True],
                         ids=["ConvNextModel", "convnext_prefix_with_head"])
def test_convnext_reader_matches_hf_and_jax(prefixed):
    """The trunk (HF's ``pooler_output``), under ``convnext.`` or not; with
    open_clip's ``mlp.fc*`` head given as ``head_state``, the projected
    features against JAX's."""
    from transformers import ConvNextConfig, ConvNextModel

    cfg = t_convnext.convnext_tiny_test()
    torch.manual_seed(4)
    hf = ConvNextModel(ConvNextConfig(
        depths=list(cfg.depths), hidden_sizes=list(cfg.hidden_sizes),
        image_size=cfg.image_size, layer_norm_eps=cfg.layer_norm_eps,
        layer_scale_init_value=cfg.layer_scale_init, drop_path_rate=0.0,
        hidden_act="gelu")).eval()
    _randomize(hf, 5)
    sd = hf.state_dict()
    factory = lambda d: t_convnext.ConvNextCLIP(cfg, device=d)
    tm = create_model_zeros(factory)
    head = None
    if prefixed:
        sd = {f"convnext.{k}": v for k, v in sd.items()}
        rng = np.random.default_rng(6)
        h2, e = 2 * cfg.embed_dim, cfg.embed_dim
        head = {"mlp.fc1.weight": T(rng.normal(size=(h2, 64)) * 0.1),
                "mlp.fc1.bias": T(rng.normal(size=h2) * 0.1),
                "mlp.fc2.weight": T(rng.normal(size=(e, h2)) * 0.1),
                "mlp.fc2.bias": T(rng.normal(size=e) * 0.1)}
    assert tc.load_convnext_state_dict(sd, tm, head_state=head) == []
    px = np.random.default_rng(0).normal(size=(2, 3, 32, 32)
                                         ).astype(np.float32)
    x = T(px.transpose(0, 2, 3, 1))
    with torch.no_grad():
        np.testing.assert_allclose(N(tm.pooled(x)),
                                   N(hf(pixel_values=T(px)).pooler_output),
                                   atol=HF_ATOL, rtol=0)
    jm = j_convnext.ConvNextCLIP(j_convnext.convnext_tiny_test(),
                                 rngs=nnx.Rngs(0))
    jc.load_convnext_from_torch(hf, jm, head_state=head)
    if prefixed:
        _same_params(tm, _via_jax(jm, factory))
        with torch.no_grad():
            got = N(tm(x))
        want = nnx.jit(lambda m, v: m(v))(jm, jnp.asarray(N(x)))
        assert rel_rms(got, np.asarray(want)) < JAX_REL_RMS
    else:
        want = _via_jax(jm, factory).state_dict()
        for name, t in tm.state_dict().items():
            if not name.startswith("head_fc"):
                assert torch.equal(t, want[name]), name


# ----------------------------------------------------------------- video2roll

_V2R_BLOCKS = {"cb1.conv": "conv1", "cb1.bn": "bn1", "cb2.conv": "conv2",
               "cb2.bn": "bn2", "down.conv": "downsample.0",
               "down.bn": "downsample.1"}
_V2R_HEADS = {"ftb2_1": "FTB2_1", "ftb2_2": "FTB2_2", "ftb3": "FTB3",
              "ftb4": "FTB4", "frb2": "FRB2", "frb3": "FRB3", "frb4": "FRB4"}


def reference_v2r_name(port_name: str) -> str:
    """The reference's (Audeo ``Video2RollNet.resnet18``) key of a port
    Video2Roll tensor."""
    parts = port_name.split(".")
    leaf = parts[-1]
    head = ".".join(parts[:-1])
    if head.startswith("stem."):
        return {"stem.conv": "conv1", "stem.bn": "bn1"}[head] + "." + leaf
    if head.startswith("layer"):
        layer, blk, rest = head.split(".", 2)
        return f"{layer}.{blk}.{_V2R_BLOCKS[rest]}.{leaf}"
    if head.split(".")[0] in _V2R_HEADS:
        top, rest = head.split(".", 1)
        rest = {"cb1.conv": "conv1", "cb1.bn": "bn1"}.get(rest, rest)
        return f"{_V2R_HEADS[top]}.{rest}.{leaf}"
    return {"toplayer.conv": "toplayer", "toplayer.bn": "toplayer_bn"}.get(
        head, head) + "." + leaf


def reference_v2r_keys(model) -> dict:
    """reference key -> shape of every tensor the reader consumes, the
    BatchNorms' ``num_batches_tracked`` counters included."""
    out = {}
    for name, t in model.state_dict().items():
        key = reference_v2r_name(name)
        out[key] = tuple(t.shape)
        if name.endswith(".running_var"):
            out[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = ()
    return out


class _Shim:
    """What JAX's reader reads: an object with ``state_dict()``."""

    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd


def test_video2roll_reader_matches_jax():
    """A synthetic state dict under the reference's key names: the port's
    parameters equal JAX's reader's, logits within 1e-5 relative RMS at the
    real 5 x 100 x 900 input."""
    factory = lambda d: t_v2r.Video2RollNet(num_classes=51, device=d)
    tm = create_model_zeros(factory)
    rng = np.random.default_rng(7)
    sd = {}
    for key, shape in reference_v2r_keys(tm).items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(5)
        elif key.endswith("running_var"):
            sd[key] = T(rng.uniform(0.5, 2.0, shape))
        elif len(shape) >= 2:
            sd[key] = T(rng.normal(size=shape) * np.sqrt(
                2.0 / np.prod(shape[1:])))
        else:
            sd[key] = T(rng.normal(size=shape) * 0.1 + ("bn" in key
                                                         and "weight" in key))
    assert tc.load_video2roll_state_dict(sd, tm) == []
    jm = j_v2r.Video2RollNet(num_classes=51, rngs=nnx.Rngs(0))
    jc.load_video2roll_from_torch(_Shim(sd), jm)
    _same_params(tm, _via_jax(jm, factory))
    x = np.random.default_rng(8).random((1, 5, 100, 900)).astype(np.float32)
    with torch.no_grad():
        got = N(tm(T(x)))
    want = nnx.jit(lambda m, v: m(v))(jm, jnp.asarray(x))
    assert rel_rms(got, np.asarray(want)) < JAX_REL_RMS


# ------------------------------------------------- full-width key coverage

def _hf_full(name: str):
    """(HF module on the meta device at the port's full-size config, its
    head state or None)."""
    t = transformers
    with torch.device("meta"):
        if name in ("clip_bigg", "clip_l336"):
            c = (t_clip.clip_vit_bigg() if name == "clip_bigg"
                 else t_clip.clip_vit_l_336())
            return t.CLIPVisionModelWithProjection(t.CLIPVisionConfig(
                hidden_size=c.hidden_size,
                intermediate_size=c.intermediate_size,
                num_hidden_layers=c.num_layers,
                num_attention_heads=c.num_heads,
                image_size=c.image_size, patch_size=c.patch_size,
                projection_dim=c.projection_dim, hidden_act=c.hidden_act))
        if name == "t5_large":
            c = t_t5.flan_t5_large()
            return t.T5EncoderModel(t.T5Config(
                vocab_size=c.vocab_size, d_model=c.d_model, d_kv=c.d_kv,
                d_ff=c.d_ff, num_layers=c.num_layers, num_heads=c.num_heads,
                feed_forward_proj="gated-gelu"))
        if name == "encodec_24khz":
            return t.EncodecModel(t.EncodecConfig())
        if name == "dinov2_giant":
            c = t_dinov2.dinov2_giant()
            return t.Dinov2Model(t.Dinov2Config(
                hidden_size=c.hidden_size, num_hidden_layers=c.num_layers,
                num_attention_heads=c.num_heads, mlp_ratio=c.mlp_ratio,
                use_swiglu_ffn=True, image_size=518, patch_size=c.patch_size))
        if name == "convnext_xxlarge":
            c = t_convnext.convnext_xxlarge()
            return t.ConvNextModel(t.ConvNextConfig(
                depths=list(c.depths), hidden_sizes=list(c.hidden_sizes),
                image_size=c.image_size))
    raise ValueError(name)


FULL = {
    "clip_bigg": (lambda d: t_clip.CLIPVisionModel(t_clip.clip_vit_bigg(),
                                                   device=d),
                  tc.load_clip_vision_state_dict),
    "clip_l336": (lambda d: t_clip.CLIPVisionModel(t_clip.clip_vit_l_336(),
                                                   device=d),
                  tc.load_clip_vision_state_dict),
    "t5_large": (lambda d: t_t5.T5Encoder(t_t5.flan_t5_large(), device=d),
                 tc.load_t5_state_dict),
    "encodec_24khz": (lambda d: t_encodec.EncodecModel(device=d),
                      tc.load_encodec_state_dict),
    "dinov2_giant": (lambda d: t_dinov2.Dinov2Model(t_dinov2.dinov2_giant(),
                                                    device=d),
                     tc.load_dinov2_state_dict),
    "convnext_xxlarge": (lambda d: t_convnext.ConvNextCLIP(
        t_convnext.convnext_xxlarge(), device=d), tc.load_convnext_state_dict),
    "video2roll": (lambda d: t_v2r.Video2RollNet(num_classes=51, device=d),
                   tc.load_video2roll_state_dict),
}


def full_key_shapes(name: str) -> dict:
    """The published key layout of ``name`` at full width: {"state": {key:
    shape}} (EnCodec in the published files' ``weight_g`` / ``weight_v``
    form), ConvNeXt also {"head": ...} (open_clip's ``mlp.fc*``), Video2Roll
    the reference's names."""
    meta = torch.device("meta")
    port = FULL[name][0](meta)
    if name == "video2roll":
        return {"state": {k: list(s) for k, s in
                          reference_v2r_keys(port).items()}}
    sd = _hf_full(name).state_dict()
    if name == "encodec_24khz":
        sd = _weight_g_form(sd)
    out = {"state": {k: list(v.shape) for k, v in sd.items()}}
    if name == "convnext_xxlarge":
        out["head"] = {"mlp.fc1.weight": list(port.head_fc1.weight.shape),
                       "mlp.fc1.bias": list(port.head_fc1.bias.shape),
                       "mlp.fc2.weight": list(port.head_fc2.weight.shape),
                       "mlp.fc2.bias": list(port.head_fc2.bias.shape)}
    return out


def golden_path(name: str) -> str:
    return os.path.join(GOLDEN, f"hf_keys_{name}.json")


@pytest.mark.parametrize("name", list(FULL))
def test_full_width_keys_are_consumed_and_fill_the_port(name):
    """On the meta device at the full-size configs: the reader consumes
    every published key and fills every port tensor with its shape, and the
    key list equals the golden file ``chip_smoke.py`` writes weights from."""
    meta = torch.device("meta")
    layout = full_key_shapes(name)
    with open(golden_path(name)) as f:
        assert json.load(f) == layout
    sd = {k: torch.empty(s, device=meta) for k, s in layout["state"].items()}
    for k in sd:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.empty((), dtype=torch.int64, device=meta)
    factory, reader = FULL[name]
    port = factory(meta)
    kw = {}
    if "head" in layout:
        kw["head_state"] = {k: torch.empty(s, device=meta)
                            for k, s in layout["head"].items()}
    assert reader(sd, port, **kw) == []


# ---------------------------------------------------------------- snapshots

_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64]


@settings(max_examples=8, deadline=None)
@given(shapes=st.lists(st.lists(st.integers(0, 5), min_size=0, max_size=3),
                       min_size=1, max_size=4),
       dtype_ix=st.lists(st.integers(0, 3), min_size=4, max_size=4))
def test_read_safetensors_equals_the_written_tensors(tmp_path_factory, shapes,
                                                     dtype_ix):
    """Files the ``safetensors`` package writes, any shape (scalars and
    empty tensors too) in F32 / F16 / BF16 / I64, read back equal."""
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(len(shapes))
    want = {}
    for i, shape in enumerate(shapes):
        dt = _DTYPES[dtype_ix[i]]
        t = torch.randn(shape, generator=gen) * 100
        want[f"t{i}.weight"] = t.to(dt)
    path = str(tmp_path_factory.mktemp("st") / "model.safetensors")
    save_file(want, path)
    got = tc.read_snapshot(os.path.dirname(path))
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


@pytest.mark.parametrize("layout",
                         ["safetensors_sharded", "bin", "bin_sharded"])
def test_read_snapshot_layouts(tmp_path, layout):
    """Sharded safetensors with their index, ``pytorch_model.bin`` and its
    sharded form: the state dict written."""
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(3)
    want = {"a.weight": torch.randn(4, 3, generator=gen),
            "b.weight": torch.randn(5, generator=gen).to(torch.bfloat16),
            "c.bias": torch.randn(2, 2, generator=gen).to(torch.float16)}
    shards = {"x-00001-of-00002": ["a.weight"],
              "x-00002-of-00002": ["b.weight", "c.bias"]}
    if layout == "bin":
        torch.save(want, tmp_path / "pytorch_model.bin")
    else:
        ext = "safetensors" if layout.startswith("safetensors") else "bin"
        stem = "model" if ext == "safetensors" else "pytorch_model"
        weight_map = {}
        for shard, keys in shards.items():
            fname = shard.replace("x", stem) + f".{ext}"
            part = {k: want[k] for k in keys}
            if ext == "safetensors":
                save_file(part, str(tmp_path / fname))
            else:
                torch.save(part, tmp_path / fname)
            weight_map.update({k: fname for k in keys})
        index = ("model.safetensors.index.json" if ext == "safetensors"
                 else "pytorch_model.bin.index.json")
        (tmp_path / index).write_text(json.dumps({"weight_map": weight_map}))
    got = tc.read_snapshot(str(tmp_path))
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    with pytest.raises(FileNotFoundError):
        tc.read_snapshot(str(tmp_path / "nothing"))


# ---------------------------------------------------------------- the CLI

def _snapshot(dir_, model) -> str:
    """``model``'s state dict saved as a single-file safetensors snapshot."""
    from safetensors.torch import save_file

    os.makedirs(dir_, exist_ok=True)
    sd = {k: v.contiguous() for k, v in model.state_dict().items()}
    if "shared.weight" in sd:                 # tied: saved once, as HF does
        sd.pop("encoder.embed_tokens.weight", None)
    save_file(sd, os.path.join(dir_, "model.safetensors"))
    return dir_


def test_convert_cli_every_flag_then_load_weights(tmp_path):
    """``python -m v2ap_torch.convert --tiny`` with every encoder flag:
    OUT/<name> holds what the in-process reader gives, and the tiny
    pipeline's ``load_weights`` (and ``Predictor.setup(ckpt=)``) loads the
    encoders; ``--pann`` reads a ``Cnn14*.pth``; ``--audioldm`` of a
    missing file raises (the flag converts:
    tests/test_torch_audioldm.py)."""
    from transformers import (CLIPVisionConfig, CLIPVisionModelWithProjection,
                              EncodecConfig, EncodecModel, T5EncoderModel)

    from tests.test_torch_eval import _pth_state_dict
    from v2ap_torch.evaluation.pann import Cnn14, pann_tiny_test
    from v2ap_torch.predict import Predictor
    from v2ap_torch.utils.checkpoint import load_model

    torch.manual_seed(0)
    ccfg = t_clip.clip_tiny_test()
    hf = {
        "encodec": EncodecModel(EncodecConfig(
            num_filters=4, hidden_size=8, upsampling_ratios=[8, 5, 4, 2],
            num_lstm_layers=1, codebook_size=1024, target_bandwidths=[24.0])),
        "t5": T5EncoderModel(_hf_t5_cfg()),
        "clip": CLIPVisionModelWithProjection(CLIPVisionConfig(
            hidden_size=ccfg.hidden_size,
            intermediate_size=ccfg.intermediate_size,
            num_hidden_layers=ccfg.num_layers,
            num_attention_heads=ccfg.num_heads, image_size=ccfg.image_size,
            patch_size=ccfg.patch_size, projection_dim=ccfg.projection_dim)),
        "dinov2": _hf_dinov2(t_dinov2.dinov2_tiny_test(), 28, 1),
    }
    from transformers import ConvNextConfig, ConvNextModel
    ncfg = t_convnext.convnext_tiny_test()
    hf["convnext"] = ConvNextModel(ConvNextConfig(
        depths=list(ncfg.depths), hidden_sizes=list(ncfg.hidden_sizes),
        image_size=ncfg.image_size))
    for i, model in enumerate(hf.values()):
        _randomize(model, 10 + i)
    argv = []
    for flag, model in hf.items():
        argv += [f"--{flag}", _snapshot(str(tmp_path / flag), model)]
    pth = tmp_path / "Cnn14_16k.pth"
    torch.save({"model": _pth_state_dict(pann_tiny_test(), 3)}, pth)
    out = tmp_path / "out"
    assert t_convert.main(argv + ["--pann", str(pth), "--out", str(out),
                                  "--tiny"]) == 0
    for flag in (*hf, "pann"):
        assert os.path.exists(out / t_convert.ENCODER_FLAGS[flag][0]
                               / "model.pt"), flag

    pred = Predictor(tiny=True, device="cpu")
    pred.setup(ckpt=str(out))
    pipe = pred.pipeline
    for flag, model in ((f, m) for f, m in hf.items()
                        if f in ("encodec", "t5", "clip")):
        want, reader = t_convert.build_encoder(flag, tiny=True)
        reader(model.state_dict(), want)
        got = {"encodec": pipe.codec, "t5": pipe.t5, "clip": pipe.clip}[flag]
        for name, t in want.state_dict().items():
            assert torch.equal(got.state_dict()[name].float(),
                               t.to(got.state_dict()[name].dtype).float()), \
                (flag, name)
    for flag in ("dinov2", "convnext", "pann"):
        model, reader = t_convert.build_encoder(flag, tiny=True)
        load_model(str(out / t_convert.ENCODER_FLAGS[flag][0]), model)
        if flag == "pann":
            sd = _pth_state_dict(pann_tiny_test(), 3)
            assert torch.equal(model.fc1.weight, sd["fc1.weight"])
            assert isinstance(model, Cnn14)
        else:
            want, _ = t_convert.build_encoder(flag, tiny=True)
            reader(hf[flag].state_dict(), want)
            _same_params(model, want)
    with pytest.raises(FileNotFoundError):
        t_convert.main(["--audioldm", str(tmp_path / "x.ckpt"), "--out",
                        str(out)])


@pytest.mark.parametrize("package", ["transformers", "safetensors"])
def test_port_imports_neither_transformers_nor_safetensors(package):
    """The port reads snapshots itself: no source of ``v2ap_torch`` (lazy
    imports included) nor ``chip_smoke.py`` imports ``package``, and
    importing every module of the port loads none of it."""
    import ast
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    for path in [*(root / "v2ap_torch").rglob("*.py"), root / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert all(n.split(".")[0] != package for n in names), path
    code = ("import importlib, pkgutil, sys, v2ap_torch\n"
            "for m in pkgutil.walk_packages(v2ap_torch.__path__, "
            "'v2ap_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] == "
            f"{package!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
