"""The port's reader of the reference's checkpoint layout
(``v2ap_torch.utils.reference_ckpt``, ``reference_manifest`` and
``python -m v2ap_torch.convert``) against the JAX package's.

Synthetic state dicts (the JAX package's ``synthetic_state_dict``, tiny
config) of the four variants load through both loaders; the port's result
must equal JAX's load carried across with ``load_jax_params``, tensor for
tensor, exactly (both start from the same weights, so tensors a two-stream
checkpoint does not hold agree too), and ``pred_head`` on the loaded weights
within 1e-6 relative RMS. Strict mode, missing and unknown keys and the
legacy names behave as in ``tests/test_reference_ckpt.py``; the full-width
key sets of ``tests/golden/reference_keys_*.json`` load strictly into
full-width CFMs on the ``meta`` device.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax
from v2ap_torch import config as t_config
from v2ap_torch import convert as t_convert_cli
from v2ap_torch.models.cfm import CFM as TCFM
from v2ap_torch.utils import reference_ckpt as t_ref
from v2ap_torch.utils import reference_manifest as t_man
from v2ap_torch.utils.convert import load_jax_params
from v2ap_tpu import config as j_config
from v2ap_tpu.models.cfm import CFM as JCFM
from v2ap_tpu.utils import reference_ckpt as j_ref
from v2ap_tpu.utils import reference_manifest as j_man
from v2ap_tpu.utils.jitting import create_model

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
B, N_LAT, NC = 2, 24, 4


def _mc(mod, variant="crossatt3", **kw):
    mc = mod.tiny_test().model
    if variant == "crossatt3_2":
        mc = dataclasses.replace(mc, notes=88, note_min=0, note_max=87)
    return dataclasses.replace(mc, **kw)


def _pair(variant="crossatt3", **kw):
    """A JAX CFM and a port CFM holding the same (initial) weights."""
    jmc, tmc = _mc(j_config, variant, **kw), _mc(t_config, variant, **kw)
    cond = j_config.tiny_test().conditioning
    jm = create_model(lambda: JCFM(jmc, cond, with_video2roll=False,
                                   rngs=nnx.Rngs(0)))
    tm = TCFM(tmc, t_config.tiny_test().conditioning, device="cpu")
    load_jax_params(tm, flatten_jax(jm))
    return jm, tm, jmc


def _assert_same_weights(jm, tm):
    ref = TCFM(tm.cfg, tm.cond_cfg, device="cpu")
    load_jax_params(ref, flatten_jax(jm))
    want = ref.state_dict()
    for name, got in tm.state_dict().items():
        assert torch.equal(got, want[name]), name


@pytest.fixture(scope="module", params=t_man.ALL_VARIANTS)
def loaded(request):
    """Each variant's synthetic state dict (scaled to 0.05 so that the
    forward stays in range) loaded strictly by both packages."""
    variant = request.param
    jm, tm, mc = _pair(variant)
    sd = {k: v * np.float32(0.05)
          for k, v in j_man.synthetic_state_dict(mc, variant, seed=3).items()}
    j_left = j_ref.load_cfm_from_reference_state_dict(dict(sd), jm,
                                                      strict=True)
    t_left = t_ref.load_cfm_from_reference_state_dict(dict(sd), tm,
                                                      strict=True)
    return variant, jm, tm, mc, sd, j_left, t_left


def test_loader_equals_jax_exactly(loaded):
    variant, jm, tm, mc, sd, j_left, t_left = loaded
    assert t_left == j_left
    assert all(k.startswith("transformer.contrastive_loss.") for k in t_left)
    assert bool(t_left) == (variant == "crossatt6")
    _assert_same_weights(jm, tm)
    if variant in t_man.TWO_STREAM_VARIANTS:
        cc = tm.transformer.cross_conditions[0]
        assert not cc.to_audio.weight[:, mc.dim + mc.dim_text:].any()
        assert not cc.to_frames.weight.any()
        assert not tm.proj_frames.weight.any() and not tm.proj_frames.bias.any()


def test_loaded_pred_head_matches_jax(loaded):
    _, jm, tm, mc, *_ = loaded
    rng = np.random.default_rng(4)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    x, text, roll = (r(B, N_LAT, mc.num_channels), r(B, N_LAT, mc.dim_text),
                     rng.random((B, N_LAT, mc.notes)).astype(np.float32))
    ctx, t = r(B, NC, mc.dim_context), np.array([0.3, 0.8], np.float32)
    mask = np.array([[True] * N_LAT, [True] * (N_LAT - 5) + [False] * 5])
    cmask = np.array([[True] * NC, [True, True, False, False]])
    # one compiled program (eager dispatch compiles every primitive)
    want = nnx.jit(lambda m, *a: m.pred_head(
        a[0], None, times=a[1], mask=a[2], text_embed=a[3],
        frames_embed=a[4], context=a[5], context_mask=a[6]))(
        jm, *map(jnp.asarray, (x, t, mask, text, roll, ctx, cmask)))
    with torch.no_grad():
        got = tm.pred_head(T(x), None, times=T(t), mask=T(mask),
                           text_embed=T(text), frames_embed=T(roll),
                           context=T(ctx), context_mask=T(cmask))
    assert rel_rms(N(got), np.asarray(want)) < 1e-6


def test_rope_permutation_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(4 * 16, 8)).astype(np.float32)
    for rot in (16, 8):
        np.testing.assert_array_equal(
            N(t_ref._rope_permute(T(w), 4, 16, rot)),
            j_ref._rope_permute(w, 4, 16, rot))


def test_converter_maps_core_keys_and_permutes_qk():
    _, tm, mc = _pair()
    sd = t_man.synthetic_state_dict(mc, "crossatt3")
    sd["text_encoder2.shared.weight"] = np.zeros((4, 4), np.float32)
    left = t_ref.load_cfm_from_reference_state_dict(sd, tm, strict=True)
    assert left == ["text_encoder2.shared.weight"]
    rp = lambda w: N(t_ref._rope_permute(T(w), mc.heads, mc.dim_head,
                                          mc.dim_head))
    np.testing.assert_array_equal(
        N(tm.transformer.audio_blocks[0].attn.to_qkv.weight),
        np.concatenate([rp(sd["transformer.layers.0.0.3.to_q.weight"]),
                        rp(sd["transformer.layers.0.0.3.to_k.weight"]),
                        sd["transformer.layers.0.0.3.to_v.weight"]]))
    np.testing.assert_array_equal(
        N(tm.transformer.audio_blocks[0].conv.weight),
        sd["transformer.layers.0.0.1.dw_conv1d.0.weight"])
    np.testing.assert_array_equal(N(tm.proj_frames.weight),
                                  sd["proj_frames.weight"])


@pytest.mark.parametrize("flags", [
    dict(if_text_conv=False), dict(if_audio_conv=False),
    dict(if_cross_attn=False),
    dict(if_text_conv=False, if_audio_conv=False, if_cross_attn=False)])
def test_flag_variants_match_jax(flags):
    """Module indices shift when conv / cross-attention modules are off."""
    jm, tm, mc = _pair(**flags)
    sd = j_man.synthetic_state_dict(mc, "crossatt3")
    assert t_ref.load_cfm_from_reference_state_dict(dict(sd), tm,
                                                    strict=True) == []
    j_ref.load_cfm_from_reference_state_dict(dict(sd), jm, strict=True)
    _assert_same_weights(jm, tm)


def test_legacy_names_match_jax():
    """Historical x_transformers names: to_out.0.weight / to_v_gates."""
    jm, tm, mc = _pair()
    sd = j_man.synthetic_state_dict(mc, "crossatt3", name_style="legacy")
    assert t_ref.load_cfm_from_reference_state_dict(dict(sd), tm,
                                                    strict=True) == []
    j_ref.load_cfm_from_reference_state_dict(dict(sd), jm, strict=True)
    _assert_same_weights(jm, tm)


def test_strict_missing_and_unknown_keys():
    _, tm, mc = _pair()
    sd = t_man.synthetic_state_dict(mc, "crossatt3")
    sd["transformer.layers.0.0.3.unknown_extra"] = np.zeros(3, np.float32)
    with pytest.raises(t_ref.MissingKey):
        t_ref.load_cfm_from_reference_state_dict(dict(sd), tm, strict=True)
    assert t_ref.load_cfm_from_reference_state_dict(dict(sd), tm) == [
        "transformer.layers.0.0.3.unknown_extra"]
    del sd["transformer.registers"]
    with pytest.raises(t_ref.MissingKey):
        t_ref.load_cfm_from_reference_state_dict(sd, tm)
    sd = t_man.synthetic_state_dict(mc, "crossatt3")
    sd["proj_in.weight"] = sd["proj_in.weight"][:, :-1]
    with pytest.raises(ValueError, match="proj_in"):
        t_ref.load_cfm_from_reference_state_dict(sd, tm)


def test_audit_report_matches_jax():
    jm, tm, mc = _pair()
    sd = j_man.synthetic_state_dict(mc, "crossatt3")
    sd["text_encoder2.shared.weight"] = np.zeros((4, 4), np.float32)
    sd["mystery.weight"] = np.zeros((2,), np.float32)
    report = t_man.audit_state_dict(sd, tm)
    assert report == j_man.audit_state_dict(sd, jm)
    assert report["unexpected_unconsumed"] == ["mystery.weight"]


@pytest.mark.parametrize("name_style", ["modern", "legacy"])
def test_manifest_equals_jax(name_style):
    for variant in t_man.ALL_VARIANTS:
        for fn in ("tiny_test", "v2a_default"):
            jmc = getattr(j_config, fn)().model
            tmc = getattr(t_config, fn)().model
            assert t_man.reference_manifest(tmc, variant, name_style) == \
                j_man.reference_manifest(jmc, variant, name_style)
        mc = _mc(t_config, variant, if_text_conv=False, if_cross_attn=False)
        assert t_man.reference_manifest(mc, variant, name_style) == \
            j_man.reference_manifest(_mc(j_config, variant, if_text_conv=False,
                                         if_cross_attn=False),
                                     variant, name_style)
    mc = _mc(t_config)
    a = t_man.synthetic_state_dict(mc, "crossatt6", seed=2)
    b = j_man.synthetic_state_dict(_mc(j_config), "crossatt6", seed=2)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("variant", t_man.ALL_VARIANTS)
def test_full_width_golden_keys_load_strictly_on_meta(variant):
    """The executed reference's key inventory at full width (Video2Roll and
    its BatchNorm counters included) fills a full-width CFM built on the
    meta device, strictly: nothing but crossatt6's FactorCL tower is left."""
    with open(os.path.join(GOLDEN, f"reference_keys_{variant}.json")) as f:
        keys = json.load(f)
    cfg = t_config.variant_preset(variant)
    cfm = TCFM(cfg.model, cfg.conditioning, device="meta",
               with_video2roll=cfg.model.video2roll)
    sd = {k: torch.empty(tuple(v), device="meta") for k, v in keys.items()}
    left = t_ref.load_cfm_from_reference_state_dict(sd, cfm, strict=True)
    assert all(k.startswith("transformer.contrastive_loss.") for k in left)
    assert bool(left) == (variant == "crossatt6")
    assert cfg.model.video2roll == any(k.startswith("video2roll_net.")
                                       for k in keys)


def test_convert_cli_then_load_weights(tmp_path, capsys):
    """``python -m v2ap_torch.convert --tiny`` writes OUT/cfm from a .pt in
    the reference's layout; ``V2APipeline.load_weights(OUT)`` serves the
    loader's weights; ``--audit`` reports; ``--audioldm`` of a missing
    file raises (the flag converts: tests/test_torch_audioldm.py; the
    encoder flags: tests/test_torch_weights_in.py)."""
    from v2ap_torch.models.clip_vit import clip_tiny_test
    from v2ap_torch.models.t5 import t5_tiny_test
    from v2ap_torch.pipelines.generate import V2APipeline

    cfg = t_config.tiny_tower_test()
    sd = t_man.synthetic_state_dict(cfg.model, "crossatt3", seed=7)
    pt = tmp_path / "ref.pt"
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in sd.items()}}, pt)
    out = tmp_path / "out"
    assert t_convert_cli.main(["--cfm-ckpt", str(pt), "--out", str(out),
                               "--tiny"]) == 0
    assert os.path.exists(out / "cfm" / "model.pt")
    assert t_convert_cli.main(["--cfm-ckpt", str(pt), "--audit",
                               "--tiny"]) == 0
    report = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert report["consumed"] == report["total"] == len(sd)
    pipe = V2APipeline(cfg, device="cpu", quantize_towers=False,
                       t5_config=t5_tiny_test(), clip_config=clip_tiny_test())
    assert pipe.load_weights(str(out)) == ["cfm"]
    want = t_convert_cli.build_cfm(51, tiny=True)
    t_ref.load_cfm_from_reference_state_dict(sd, want, strict=True)
    got = pipe.cfm.state_dict()
    for name, v in want.state_dict().items():
        assert torch.equal(got[name], v), name
    with pytest.raises(FileNotFoundError):
        t_convert_cli.main(["--audioldm", str(tmp_path / "missing.ckpt"),
                            "--out", str(out)])
