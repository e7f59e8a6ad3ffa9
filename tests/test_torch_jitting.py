"""``v2ap_torch.utils.jitting`` on the CPU: ``cast_params`` changes no
result of a bf16 CFM (bit-equal, ``torch.equal``) and touches only what
every call already cast; ``create_model_zeros`` builds on the meta device
and takes the JAX package's weights like a normal build;
``machine_fingerprint`` and ``model_rngs`` against their JAX
counterparts. The captured CUDA programs are tested on the card
(``tests/test_torch_cuda.py``); on the CPU the pipeline keeps none."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_ops import N, T, flatten_jax, randomize_jax
from v2ap_torch import config as t_config
from v2ap_torch.models import cfm as t_cfm
from v2ap_torch.models import clip_vit as t_clip
from v2ap_torch.ops.conv import DepthwiseConv1d
from v2ap_torch.ops.layers import Conv2d, Embed, Linear
from v2ap_torch.utils import jitting as t_jitting
from v2ap_torch.utils.convert import load_jax_params
from v2ap_tpu.models import clip_vit as j_clip
from v2ap_tpu.utils import jitting as j_jitting

torch.set_num_threads(2)


def _bf16_cfm(seed: int = 0) -> t_cfm.CFM:
    """tiny_test() in bf16 with Video2Roll, every parameter random (the
    zero-initialised fusions and gates too, so every layer matters)."""
    base = t_config.tiny_test()
    mcfg = dataclasses.replace(base.model, dtype="bfloat16", dropout=0.0)
    model = t_cfm.CFM(mcfg, base.conditioning, device="cpu",
                      with_video2roll=True)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model.eval()


def _inputs(cfg, b=2, n=24, seed=1):
    rng = np.random.default_rng(seed)
    r = lambda *s: T(rng.normal(size=s).astype(np.float32))
    return dict(x=r(b, n, cfg.num_channels), text=r(b, n, cfg.dim_text),
                roll=T(rng.random((b, n, cfg.notes)).astype(np.float32)),
                ctx=r(b, 5, cfg.dim_context),
                cmask=T(np.arange(5)[None, :] < np.array([[5], [3]])),
                mask=T(np.arange(n)[None, :] < np.array([[n], [n - 7]])))


@pytest.fixture(scope="module")
def cast_pair():
    per_call = _bf16_cfm()
    once = copy.deepcopy(per_call)
    n_cast = t_jitting.cast_params(once, torch.bfloat16)
    return per_call, once, n_cast


def test_cast_params_pred_head_is_bit_equal(cast_pair):
    """One transformer evaluation, with a prompt context and key masks."""
    per_call, once, _ = cast_pair
    i = _inputs(per_call.cfg)
    times = T(np.array([0.25, 0.7], np.float32))
    outs = []
    with torch.inference_mode():
        for m in (per_call, once):
            outs.append(m.pred_head(
                i["x"], None, times=times, mask=i["mask"],
                text_embed=i["text"], frames_embed=i["roll"],
                context=i["ctx"], context_mask=i["cmask"]))
    assert outs[0].dtype == torch.float32
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("passes", [1, 2], ids=["sample", "multipass"])
def test_cast_params_sampling_is_bit_equal(cast_pair, passes):
    """A 3-step CFG trajectory (and a restart pass) and the Video2Roll roll
    of a few strips."""
    per_call, once, _ = cast_pair
    i = _inputs(per_call.cfg, seed=2)
    sampler = t_config.SamplerConfig(steps=3, cfg_strength=2.0)
    noises = torch.randn((1,) + tuple(i["x"].shape),
                         generator=torch.Generator().manual_seed(3))
    outs = []
    with torch.inference_mode():
        for m in (per_call, once):
            kw = dict(text_embed=i["text"], frames_embed=i["roll"],
                      context=i["ctx"], context_mask=i["cmask"],
                      mask=i["mask"], sampler=sampler)
            lat = (m.sample(i["x"], **kw) if passes == 1 else
                   m.sample_multipass(i["x"], passes=2, noises=noises, **kw))
            strips = torch.rand(1, 4, 100, 900,
                                generator=torch.Generator().manual_seed(4))
            outs.append((lat, m.encode_frames(strips, 24)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_cast_params_touches_only_what_every_call_casts(cast_pair):
    """bf16 copies of exactly the weights and biases of the bf16 Linear,
    Embed, Conv2d and depthwise-conv layers; every other parameter (norms,
    the time MLP, the AdaLN projections, BatchNorm) stays float32 and
    unchanged."""
    per_call, once, n_cast = cast_pair
    casting = (Linear, Embed, Conv2d, DepthwiseConv1d)
    want = set()
    for name, m in per_call.named_modules():
        if isinstance(m, casting) and m.dtype == torch.bfloat16:
            want |= {f"{name}.{leaf}" for leaf in ("weight", "bias")
                     if getattr(m, leaf, None) is not None}
    before = dict(per_call.named_parameters())
    got = {k for k, p in once.named_parameters() if p.dtype == torch.bfloat16}
    assert got == want and n_cast == len(want) > 50
    for k, p in once.named_parameters():
        if k in want:
            assert torch.equal(p, before[k].to(torch.bfloat16))
        else:
            assert p.dtype == torch.float32 and torch.equal(p, before[k]), k
    assert "transformer.audio_blocks.0.attn_norm.to_gamma.weight" not in got
    assert "transformer.time_mlp.proj.weight" not in got
    # a second cast finds nothing left to cast; an f32 model has nothing
    assert t_jitting.cast_params(once, torch.bfloat16) == 0
    f32 = t_cfm.CFM(t_config.tiny_test().model, device="cpu")
    assert t_jitting.cast_params(f32, torch.bfloat16) == 0


def test_create_model_zeros_builds_on_meta_and_loads_weights():
    """A CLIP tower and a CFM built on the meta device: zeros on the CPU,
    the normal build's names, shapes and dtypes; loading the JAX package's
    CLIP weights gives the normal build's features."""
    cfg = t_clip.clip_tiny_test()
    zeros = t_jitting.create_model_zeros(
        lambda d: t_clip.CLIPVisionModel(cfg, device=d))
    normal = t_clip.CLIPVisionModel(cfg, device="cpu")
    sd_z, sd_n = zeros.state_dict(), normal.state_dict()
    assert list(sd_z) == list(sd_n)
    for k in sd_n:
        assert sd_z[k].shape == sd_n[k].shape and sd_z[k].dtype == sd_n[k].dtype
        assert sd_z[k].device.type == "cpu" and not sd_z[k].any()
    from flax import nnx
    jm = j_clip.CLIPVisionModel(j_clip.clip_tiny_test(), rngs=nnx.Rngs(0))
    randomize_jax(jm, 1, scale=0.05)
    for m in (zeros, normal):
        load_jax_params(m, flatten_jax(jm))
    px = T(np.random.default_rng(2).normal(
        size=(3, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(zeros(px), normal(px))

    base = t_config.tiny_test()
    cfm = t_jitting.create_model_zeros(
        lambda d: t_cfm.CFM(base.model, base.conditioning, device=d))
    assert cfm.dropout_generator is None
    assert all(not p.any() for p in cfm.parameters())
    assert {k: v.shape for k, v in cfm.state_dict().items()} == {
        k: v.shape for k, v in
        t_cfm.CFM(base.model, base.conditioning, device="cpu"
                  ).state_dict().items()}


def test_machine_fingerprint_matches_jax():
    assert t_jitting.machine_fingerprint() == j_jitting.machine_fingerprint()
    assert len(t_jitting.machine_fingerprint()) == 12


def test_model_rngs_is_a_seeded_generator():
    """The same seed gives the same stream, another seed another one."""
    a, b, c = (t_jitting.model_rngs(s) for s in (7, 7, 8))
    assert isinstance(a, torch.Generator) and a.device.type == "cpu"
    x, y, z = (torch.randn(16, generator=g) for g in (a, b, c))
    assert torch.equal(x, y) and not torch.equal(x, z)


def test_cpu_pipeline_samples_eagerly():
    """On the CPU the pipeline keeps no captured programs: its sampler is
    CFM.sample itself, bit-equal."""
    from tests.test_torch_pipeline import _cfg, _port_pipeline
    tp = _port_pipeline(_cfg(t_config))
    assert tp.graphs is None
    i = _inputs(tp.cfg.model, n=96, seed=5)
    ctx = torch.zeros(2, 1, tp.cfg.model.dim_context)
    ones = torch.ones(2, 1, dtype=torch.bool)
    sampler = t_config.SamplerConfig(steps=3)
    got = tp._sample(i["x"], i["text"], i["roll"], ctx, ones, i["mask"],
                     sampler)
    with torch.inference_mode():
        want = tp.cfm.sample(i["x"], text_embed=i["text"],
                             frames_embed=i["roll"], context=ctx,
                             context_mask=ones, mask=i["mask"],
                             sampler=sampler)
    assert torch.equal(got, want)
    assert N(got).shape == (2, 96, tp.cfg.model.num_channels)


def test_batch_bucket_and_pad_batch():
    """Batches round up to powers of two; padding repeats the last row
    along the batch axis and leaves None and full batches as they are."""
    assert [t_jitting.batch_bucket(b) for b in range(1, 10)] == \
        [1, 2, 4, 4, 8, 8, 8, 8, 16]
    t = torch.arange(12.0).reshape(3, 4)
    p = t_jitting.pad_batch(t, 4)
    assert torch.equal(p[:3], t) and torch.equal(p[3], t[2])
    noises = torch.arange(24.0).reshape(2, 3, 4)
    p = t_jitting.pad_batch(noises, 4, dim=1)
    assert p.shape == (2, 4, 4) and torch.equal(p[:, 3], noises[:, 2])
    assert t_jitting.pad_batch(None, 4) is None
    assert t_jitting.pad_batch(t, 3) is t


class _EagerPrograms:
    """Stands in for ``CapturedPrograms`` on the CPU: records each call's
    key and runs the program's function eagerly."""

    def __init__(self):
        self.keys = []

    def run(self, key, fn, inputs, warmup=None):
        self.keys.append(key)
        return fn(*inputs)


def test_sampler_keys_are_bounded_by_batch_buckets():
    """Where the pipeline keeps programs, batches of 1 to 8 clips make four
    keys (batch 1, 2, 4, 8), and each row of a padded batch is its row of
    the unpadded eager sampler (rows do not mix), for ``_sample`` and for
    ``_sample_multipass`` (whose restart noise has its batch on axis 1)."""
    from tests.test_torch_pipeline import _cfg, _port_pipeline
    tp = _port_pipeline(_cfg(t_config))
    m = tp.cfg.model
    sampler = t_config.SamplerConfig(steps=3)
    programs = _EagerPrograms()
    worst = 0.0
    for b in range(1, 9):
        rng = np.random.default_rng(b)
        r = lambda *s: T(rng.normal(size=s).astype(np.float32))
        args = (r(b, 96, m.num_channels), r(b, 96, m.dim_text),
                T(rng.random((b, 96, m.notes)).astype(np.float32)),
                r(b, 3, m.dim_context), torch.ones(b, 3, dtype=torch.bool),
                torch.arange(96)[None].repeat(b, 1) < 80)
        noises = r(1, b, 96, m.num_channels)
        tp.graphs = None
        want = tp._sample(*args, sampler)
        want_mp = tp._sample_multipass(*args, sampler, noises, 2, 0.6)
        tp.graphs = programs
        got = tp._sample(*args, sampler)
        got_mp = tp._sample_multipass(*args, sampler, noises, 2, 0.6)
        assert got.shape == want.shape and got_mp.shape == want_mp.shape
        for g, w in ((got, want), (got_mp, want_mp)):
            worst = max(worst, float((g - w).norm() / w.norm()))
    assert worst < 1e-6, worst
    # x0's (shape, dtype) follows the kind, the sampler, passes, restart_t
    batches = {(k[0], k[2 if k[0] == "sample" else 4][0][0])
               for k in programs.keys}
    assert batches == {(kind, b) for kind in ("sample", "multipass")
                       for b in (1, 2, 4, 8)}
