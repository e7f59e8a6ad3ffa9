"""The port's training pipeline end to end on the CPU
(``v2ap_torch.training.pipeline.TrainingPipeline``, checkpoints and resume,
``V2APipeline.load_weights``, ``python -m v2ap_torch.train``), against the
JAX package's where the two compute the same thing.

``device_batch`` is compared with JAX's on the same ``Batch`` (a synthetic
mp4 decoded by both, a piano row with its ``.3.npy`` roll) and the JAX
pipeline's weights carried across: latents 1e-5 relative RMS (the tiny
EnCodec encoder), CLIP features 1e-5 absolute (as the serving tests), the
T5 context 1e-4 relative RMS, the roll and the strips exact. Everything
else is the port's own behaviour: checkpoints, exact resume (bit-equal
state), ``load_weights`` then ``generate`` bit-equal to the same weights
loaded in process, the video-prompt flip, the CLI.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests.test_pipeline import write_synthetic_video
from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, flatten_jax, randomize_jax
from tests.test_torch_video2roll import randomize_params_and_stats
from v2ap_torch import config as t_config
from v2ap_torch import train as t_train
from v2ap_torch.data import dataset as t_dataset
from v2ap_torch.data import manifests as t_man
from v2ap_torch.data.audio_io import write_wav
from v2ap_torch.models.clip_vit import clip_tiny_test as t_clip_tiny
from v2ap_torch.models.t5 import t5_tiny_test as t_t5_tiny
from v2ap_torch.pipelines.generate import V2APipeline
from v2ap_torch.training import resilience as t_res
from v2ap_torch.training.pipeline import TrainingPipeline
from v2ap_torch.utils import checkpoint as t_ckpt
from v2ap_torch.utils.convert import load_jax_params
from v2ap_torch.utils.jitting import cast_params
from v2ap_tpu import config as j_config

torch.set_num_threads(2)

TARGET = 48                         # latents per training window


def _cfg(mod, **train):
    """tiny_tower_test (tower width 16, T5 32, 8 latent channels) with
    Video2Roll, 48-latent windows, no feature caches (both packages compute
    the features), a fast schedule."""
    cfg = mod.tiny_tower_test()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, video2roll=True),
        conditioning=dataclasses.replace(cfg.conditioning,
                                         feature_cache=False),
        data=dataclasses.replace(cfg.data, target_length=TARGET,
                                 min_target_length=TARGET),
        train=dataclasses.replace(cfg.train, learning_rate=1e-3,
                                  warmup_steps=2, decay_steps=50,
                                  save_step=2, **train))


def _port(cfg, work_dir):
    return TrainingPipeline(cfg, work_dir=str(work_dir), seed=0,
                            t5_config=t_t5_tiny(), clip_config=t_clip_tiny(),
                            device="cpu")


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """Three wavs, a synthetic 25 fps mp4 with its sibling wav and a
    ``.3.npy`` roll (88 keys), and the Batch both pipelines take."""
    tmp = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(50)
    wavs = []
    for i in range(3):
        path = str(tmp / f"w{i}.wav")
        write_wav(path, (rng.normal(size=12_000) * 0.2).astype(np.float32))
        wavs.append(path)
    video = str(tmp / "clip.mp4")
    if not write_synthetic_video(video, frames=30, fps=25):
        pytest.skip("no video writer available")
    write_wav(str(tmp / "clip.wav"),
              (rng.normal(size=30_000) * 0.2).astype(np.float32))
    np.save(str(tmp / "clip.3.npy"),
            (rng.random((120, 88)) > 0.7).astype(np.float32))
    n_samp = TARGET * 320
    batch = t_dataset.Batch(
        waveforms=(rng.normal(size=(3, n_samp)) * 0.2).astype(np.float32),
        lens=np.full((3,), TARGET, np.int32),
        captions=["a dog barks", "piano", "piano"],
        video_paths=[None, video, video], piano=[False, True, False],
        video_drop_prompt=np.asarray([False, False, True]),
        audio_drop_prompt=np.zeros(3, bool))
    return dict(tmp=tmp, wavs=wavs, video=video, batch=batch)


@pytest.fixture(scope="module")
def pipelines(media):
    """The JAX TrainingPipeline (weights redrawn) and the port's, with the
    JAX weights."""
    from v2ap_tpu.models.clip_vit import clip_tiny_test
    from v2ap_tpu.models.t5 import t5_tiny_test
    from v2ap_tpu.training.pipeline import TrainingPipeline as JTP

    jp = JTP(_cfg(j_config), work_dir=str(media["tmp"] / "jrun"), seed=0,
             t5_config=t5_tiny_test(), clip_config=clip_tiny_test())
    for i, model in enumerate((jp.pipe.cfm, jp.pipe.codec, jp.pipe.clip,
                               jp.pipe.t5)):
        randomize_jax(model, 60 + i, scale=0.05)
    randomize_params_and_stats(jp.pipe.cfm.video2roll, 64)
    tp = _port(_cfg(t_config), media["tmp"] / "trun")
    for name in ("cfm", "codec", "clip", "t5"):
        load_jax_params(getattr(tp.pipe, name),
                        flatten_jax(getattr(jp.pipe, name)))
    return jp, tp


def test_device_batch_matches_jax(pipelines, media):
    """Latents (EnCodec encoder), CLIP features at the latent rate, the
    prompt context with the flipped row zeroed, the ground-truth roll
    sliced to the 51 keys, the piano row's strips in [0, 1]."""
    jp, tp = pipelines
    want = {k: np.asarray(v) for k, v in
            jp.device_batch(media["batch"]).items()}
    got = {k: N(v.float() if v.is_floating_point() else v)
           for k, v in tp.device_batch(media["batch"]).items()}
    assert set(got) == set(want) == {"latents", "lens", "text_embed",
                                     "context", "context_mask", "midis",
                                     "frames"}
    for k in got:
        assert got[k].shape == want[k].shape, k
    assert rel_rms(got["latents"], want["latents"]) < 1e-5
    np.testing.assert_allclose(got["text_embed"], want["text_embed"],
                               atol=1e-5, rtol=0)
    assert not got["text_embed"][0].any() and got["text_embed"][1].any()
    assert rel_rms(got["context"], want["context"]) < 1e-4
    assert not got["context"][2].any()
    for k in ("lens", "context_mask", "midis", "frames"):
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype), k)
    assert got["midis"][1].any() and not got["midis"][2].any()
    assert got["frames"][1].any() and not got["frames"][0].any()
    assert 0.0 <= got["frames"].min() and got["frames"].max() <= 1.0


def test_video_drop_prompt_keeps_clip_stream(pipelines, media):
    """video_drop_prompt swaps only the prompt ("the sound of X X") and
    zeroes its context; the CLIP stream stays (the JAX package's
    regression test, on the port)."""
    _, tp = pipelines
    batch = dataclasses.replace(
        media["batch"], video_paths=[media["video"]] * 2, piano=[False] * 2,
        captions=["a piano"] * 2, waveforms=media["batch"].waveforms[:2],
        lens=media["batch"].lens[:2],
        video_drop_prompt=np.asarray([True, False]),
        audio_drop_prompt=np.zeros(2, bool))
    dev = tp.device_batch(batch)
    text, ctx = N(dev["text_embed"]), N(dev["context"].float())
    assert np.abs(text[0]).sum() > 0 and np.abs(text[1]).sum() > 0
    np.testing.assert_allclose(text[0], text[1], atol=1e-5)
    assert np.abs(ctx[0]).sum() == 0.0 and np.abs(ctx[1]).sum() > 0
    assert "frames" not in dev


def test_primed_caches_feed_a_video_that_does_not_decode(tmp_path):
    """A machine without cv2 trains from the caches beside the video: the
    tower's features and the strips written from decoded frames (the
    pipeline's own ``frames_cache`` / ``strips_cache``) serve a path that
    does not exist; without them the row gets zero features and no
    frames, as in JAX."""
    cfg = _cfg(t_config)
    cfg = cfg.replace(conditioning=dataclasses.replace(
        cfg.conditioning, feature_cache=True))
    tp = _port(cfg, tmp_path / "run")
    video = str(tmp_path / "none.mp4")
    rng = np.random.default_rng(51)
    frames = rng.integers(0, 256, (30, 24, 24, 3), dtype=np.uint8)
    strips = rng.integers(0, 256, (30, 100, 900), dtype=np.uint8)
    batch = t_dataset.Batch(
        waveforms=np.zeros((1, TARGET * 320), np.float32),
        lens=np.full((1,), TARGET, np.int32), captions=["piano"],
        video_paths=[video], piano=[True],
        video_drop_prompt=np.zeros(1, bool),
        audio_drop_prompt=np.zeros(1, bool))
    cold = tp.device_batch(batch)
    assert not cold["text_embed"].any() and "frames" not in cold
    tp.pipe.encode_video_frames_clip(video, TARGET,
                                     frames_cache=[(frames, 1.2, 1)])
    tp.pipe.encode_piano_frames(video, TARGET, strips_cache=[(strips, 1.2)])
    warm = tp.device_batch(batch)
    assert warm["text_embed"].abs().sum() > 0 and warm["frames"].any()


def _batcher(media, cfg, seed=0):
    samples = [t_man.Sample(p, f"sound {i}", "c")
               for i, p in enumerate(media["wavs"])]
    samples.append(t_man.Sample(media["video"], "piano", "p", is_video=True,
                                is_piano=True))
    return t_dataset.TrainBatcher(samples, cfg.data, batch_size=2, seed=seed,
                                  mix_prob=0.0)


@pytest.fixture(scope="module")
def fitted(media):
    """4 steps with save_step 2, EMA on, an eval batcher; then a fresh
    pipeline on the same work_dir."""
    cfg = _cfg(t_config, use_ema=True, switch_ema_every=3)
    work = media["tmp"] / "fit"
    tp = _port(cfg, work)
    final = tp.fit(_batcher(media, cfg), num_steps=4, log_every=1,
                   eval_batcher=_batcher(media, cfg, seed=1))
    return tp, cfg, work, final


def test_fit_runs_logs_and_checkpoints(fitted):
    tp, _, work, final = fitted
    assert final == 4 == tp.trainer.step
    beat = json.load(open(work / "heartbeat.json"))
    assert beat["step"] == 4 and np.isfinite(beat["loss"])
    recs = [json.loads(line) for line in open(work / "logs" / "metrics.jsonl")]
    steps = [r["step"] for r in recs if "loss" in r]
    assert steps == [1, 2, 3, 4]
    assert all(np.isfinite([r["loss"], r["flow"], r["midi"]]).all()
               for r in recs if "loss" in r)
    assert [r["step"] for r in recs if "val_loss" in r] == [2, 4]
    assert tp.resumer.mgr.all_steps() == [2, 4]
    assert sorted(os.listdir(work / "ckpts")) == ["2.pt", "4.pt"]


def test_resume_restores_exact_state(fitted):
    """A fresh pipeline on the same work_dir resumes at step 4 with the
    parameters and buffers, the AdamW moments and count, the EMA shadow
    and the dropout generator bit-equal; then it trains on."""
    tp, cfg, work, _ = fitted
    again = _port(cfg, work)
    assert again.resumer.maybe_resume() == 4 == again.trainer.step
    a, b = tp.trainer.state_dict(), again.trainer.state_dict()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, v in a["ema"].items():
        assert torch.equal(v, b["ema"][k]), k
    assert torch.equal(a["rng"], b["rng"])
    oa, ob = a["opt"], b["opt"]
    assert oa["count"] == ob["count"] == 4
    for i, st in oa["adamw"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(st[k], ob["adamw"]["state"][i][k]), (i, k)
    assert again.fit(iter([_noise_batch()]), num_steps=5) == 5


def _noise_batch():
    """One V2A host batch of noise."""
    rng = np.random.default_rng(52)
    return t_dataset.Batch(
        waveforms=(rng.normal(size=(2, TARGET * 320)) * 0.2).astype(
            np.float32),
        lens=np.full((2,), TARGET, np.int32), captions=["a", "b"],
        video_paths=[None, None], piano=[False, False],
        video_drop_prompt=np.zeros(2, bool),
        audio_drop_prompt=np.zeros(2, bool))


def test_checkpoint_manager_keeps_the_last(tmp_path):
    """keep-last-N, the latest step, atomic writes (no temporary left)."""
    cfg = t_config.TrainConfig(use_ema=True)
    from v2ap_torch.models.cfm import CFM
    from v2ap_torch.training.trainer import Trainer
    trainer = Trainer(CFM(t_config.tiny_test().model, device="cpu"), cfg)
    mgr = t_ckpt.CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    assert mgr.latest_step() is None
    for step in (1, 2, 3):
        trainer.step = step
        mgr.save(step, trainer)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "c")) == ["2.pt", "3.pt"]
    trainer.step = 0
    assert mgr.restore(trainer, step=2) == 2 == trainer.step
    with pytest.raises(FileNotFoundError):
        t_ckpt.CheckpointManager(str(tmp_path / "e")).restore(trainer)


def test_load_weights_then_generate_equals_in_process(fitted, media):
    """``save_model`` of the EMA CFM to ``serve/cfm``, a fresh serving
    pipeline's ``load_weights(serve)`` -> ["cfm"], and its generate equals,
    bit for bit, a pipeline given the same state in process; a bare CFM
    directory loads too."""
    tp, cfg, work, _ = fitted
    ema = {k: v.clone() for k, v in tp.trainer.ema.shadow.items()}
    state = {**tp.pipe.cfm.state_dict(), **ema}
    tp.trainer.ema.copy_to(tp.pipe.cfm)
    serve = work / "serve"
    t_ckpt.save_model(str(serve / "cfm"), tp.pipe.cfm, step=4)
    kw = dict(device="cpu", t5_config=t_t5_tiny(), clip_config=t_clip_tiny(),
              quantize_towers=False)
    loaded = V2APipeline(cfg, **kw)
    assert loaded.load_weights(str(serve)) == ["cfm"]
    ref = V2APipeline(cfg, **kw)
    ref.cfm.load_state_dict(state)
    frames = np.random.default_rng(53).integers(0, 256, (25, 24, 24, 3),
                                                dtype=np.uint8)
    outs = [p.generate(None, steps=2, seed=3,
                       frames_cache=[(frames, 1.0, 1)])[0]
            for p in (loaded, ref)]
    np.testing.assert_array_equal(outs[0], outs[1])
    bare = V2APipeline(cfg, **kw)
    assert bare.load_weights(str(serve / "cfm")) == ["cfm"]
    for k, v in bare.cfm.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_load_weights_into_bf16_layers_rounds_as_cast_params(tmp_path):
    """A float32 state loaded into the serving CFM's bf16-stored layers
    equals that state put into a trainable CFM and then ``cast_params``."""
    cfg = t_config.tiny_test()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="bfloat16",
                                                video2roll=True))
    kw = dict(device="cpu", quantize_towers=False, t5_config=t_t5_tiny(),
              clip_config=t_clip_tiny())
    trained = V2APipeline(cfg, seed=5, trainable_cfm=True, **kw)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in trained.cfm.parameters())
    assert not any(p.requires_grad for p in trained.t5.parameters())
    with torch.no_grad():
        for p in trained.cfm.parameters():
            p.add_(torch.randn_like(p) * 1e-3)
    t_ckpt.save_model(str(tmp_path / "cfm"), trained.cfm)
    serving = V2APipeline(cfg, **kw)
    assert serving.load_weights(str(tmp_path)) == ["cfm"]
    cast_params(trained.cfm, torch.bfloat16)
    got, want = serving.cfm.state_dict(), trained.cfm.state_dict()
    assert any(v.dtype == torch.bfloat16 for v in got.values())
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# -------------------------------------------------------------------- CLI

def _corpus(root, media):
    """Two of the default corpora's manifests: audio and a video."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "audioset_sl.scp"), "w") as f:
        f.writelines(f"{p}\tsound {i}\n" for i, p in enumerate(media["wavs"]))
    with open(os.path.join(root, "vggsound_train.scp"), "w") as f:
        f.write(f"{media['video']}\ta video\n")


def test_train_cli_tiny_runs(tmp_path, media, capsys):
    """``python -m v2ap_torch.train --tiny --device cpu --steps 2`` on a tiny
    corpus exits 0 at step 2; without samples it exits 2."""
    root = str(tmp_path / "corpus")
    _corpus(root, media)
    work = tmp_path / "run"
    assert t_train.main(["--corpora-root", root, "--tiny", "--device", "cpu",
                         "--steps", "2", "--batch-size", "2",
                         "--work-dir", str(work)]) == 0
    assert "finished at step 2" in capsys.readouterr().out
    assert os.path.exists(work / "heartbeat.json")
    assert t_train.main(["--corpora-root", str(tmp_path / "empty"),
                         "--tiny", "--device", "cpu", "--steps", "1"]) == 2


def test_train_cli_config_and_remat(tmp_path):
    """The JAX package's ``to_json`` reads into the port's config; remat is
    on with "dots" unless --no-remat or --tiny, as in JAX's build_config."""
    path = tmp_path / "cfg.json"
    path.write_text(j_config.variant_preset("crossatt3_2").to_json())
    defaults = dict(variant="crossatt3", config=None, tiny=False,
                    no_remat=False, remat_policy="dots", grad_accum=None,
                    batch_size=None, dpo=False, contrastive=False,
                    video_encoder=None)
    parse = lambda *a: t_train.build_config(
        type("Args", (), {**defaults, **dict(a)})())
    cfg = parse(("config", str(path)), ("grad_accum", 2))
    assert cfg.model.notes == 88 and cfg.train.grad_accum == 2
    assert cfg.model.remat and cfg.model.remat_policy == "dots"
    assert not parse(("no_remat", True)).model.remat
    tiny = parse(("tiny", True))
    assert not tiny.model.remat and tiny.model.num_channels == 8
    assert parse(("remat_policy", "full")).model.remat_policy == "full"
    j_cfg = j_config.variant_preset("crossatt3_2")
    t_cfg = t_config.V2APConfig.from_json(j_cfg.to_json())
    assert t_cfg.to_dict() == j_cfg.to_dict()
    assert t_config.V2APConfig.from_json(t_cfg.to_json()) == t_cfg


@pytest.mark.parametrize("mode", ["clip_vit", "clip_vit2", "clip_convnext",
                                  "dinov2", "mixed"])
def test_train_cli_video_encoder_matches_jax(mode):
    """``--video-encoder`` sets the conditioning's tower(s), and "mixed" the
    CFM's 4608-d ``proj_text``, as ``scripts/train.py``'s build_config
    (loaded with importlib) sets them."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "train.py"
    spec = importlib.util.spec_from_file_location("jax_train_script", path)
    j_train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_train)
    args = type("Args", (), dict(
        variant="crossatt3", config=None, tiny=False, no_remat=False,
        remat_policy="dots", grad_accum=None, batch_size=None, dpo=False,
        contrastive=False, video_encoder=mode))()
    t_cfg, j_cfg = t_train.build_config(args), j_train.build_config(args)
    assert t_cfg.conditioning.video_encoder == mode
    assert t_cfg.model.dim_text_raw == (4608 if mode == "mixed" else None)
    assert t_cfg.to_dict() == j_cfg.to_dict()


@pytest.mark.parametrize("args", [
    ["--host-id", "0"], ["--num-hosts", "2"], ["--no-mesh"]])
def test_train_cli_multihost_options_are_honoured(args, tmp_path, media,
                                                  monkeypatch, capsys):
    """As JAX's ``scripts/train.py`` on one device: ``--host-id`` /
    ``--num-hosts`` reach ``TrainBatcher`` (defaults 0 and 1, from
    ``host_shard_info`` in one process), and ``--no-mesh`` trains (one
    process builds no mesh either way)."""
    from v2ap_torch.data import dataset as t_data

    root = str(tmp_path / "corpus")
    _corpus(root, media)
    seen = []
    real = t_data.TrainBatcher

    def recording(*a, **kw):
        seen.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(t_data, "TrainBatcher", recording)
    assert t_train.main(["--corpora-root", root, "--tiny", "--device", "cpu",
                         "--steps", "1", "--batch-size", "2", "--work-dir",
                         str(tmp_path / "run"), *args]) == 0
    assert "finished at step 1" in capsys.readouterr().out
    want = {"--host-id": (0, 1), "--num-hosts": (0, 2),
            "--no-mesh": (0, 1)}[args[0]]
    assert (seen[0]["host_id"], seen[0]["num_hosts"]) == want
    if args[0] == "--num-hosts":
        assert real([], batch_size=2, host_id=1, num_hosts=2).video_samples \
            == []


@pytest.mark.parametrize("args", [
    ["--variant", "crossatt"], ["--variant", "crossatt6"], ["--dpo"],
    ["--contrastive"], ["--dpo", "--contrastive", "--variant", "crossatt6"]],
    ids=["crossatt", "crossatt6", "dpo", "contrastive", "dpo-crossatt6"])
def test_train_cli_two_stream_dpo_contrastive(args, tmp_path, media):
    """The two-stream variants, DPO and FactorCL train 2 steps through
    ``--tiny --device cpu`` at the default batch of 8 (the contrastive
    gate open) on the corpus plus ``pairs.scp`` (a*/b* wav pairs); the
    metrics logged at the last step hold finite losses, and nonzero ``dpo`` / ``contrastive`` when
    they are on."""
    root = str(tmp_path / "corpus")
    _corpus(root, media)
    rng = np.random.default_rng(51)
    pairs = tmp_path / "pairs"
    pairs.mkdir()
    with open(os.path.join(root, "pairs.scp"), "w") as f:
        for i in range(2):
            for side in "ab":
                path = str(pairs / f"{side}{i}.wav")
                write_wav(path, (rng.normal(size=12_000) * 0.2
                                 ).astype(np.float32))
                f.write(f"{path}\tpair {i}\n")
    work = tmp_path / "run"
    assert t_train.main(["--corpora-root", root, "--tiny", "--device", "cpu",
                         "--steps", "2", "--work-dir", str(work),
                         *args]) == 0
    recs = [json.loads(line)
            for line in open(work / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [2]             # the last step
    dpo = "--dpo" in args
    con = "--contrastive" in args or "crossatt6" in args
    for r in recs:
        assert np.isfinite(r["loss"]) and np.isfinite(r["flow"])
        assert ("dpo" in r) == dpo and ("contrastive" in r) == con
        for key in ("dpo", "contrastive"):
            if key in r:
                assert np.isfinite(r[key]) and r[key] != 0.0, (key, r)


def test_config_presets_match_jax():
    for name in t_config.VARIANTS:
        assert t_config.variant_preset(name).to_dict() == \
            j_config.variant_preset(name).to_dict()
    for name in ("tiny_tower_test", "dryrun_test"):
        assert getattr(t_config, name)().to_dict() == \
            getattr(j_config, name)().to_dict()
    mesh = {"data_axis": "d", "model_axis": "m", "data_parallel": 2,
            "model_parallel": 2}
    t = t_config.V2APConfig.from_dict({"mesh": mesh})
    assert t.mesh == t_config.MeshConfig(**mesh)
    assert t.to_dict()["mesh"] == \
        j_config.V2APConfig.from_dict({"mesh": mesh}).to_dict()["mesh"]
    assert t_config.V2APConfig.from_json(t.to_json()) == t
    with pytest.raises(KeyError):
        t_config.V2APConfig.from_dict({"model": {"bogus": 1}})


# ------------------------------------------------------------- resilience

def test_watchdog_and_grad_guard(tmp_path):
    path = str(tmp_path / "hb.json")
    wd = t_res.Watchdog(path)
    wd.beat(step=5, loss=1.0)
    assert json.load(open(path))["step"] == 5
    assert not t_res.Watchdog.is_stalled(path, stall_seconds=60)
    assert t_res.Watchdog.is_stalled(path, stall_seconds=-1)
    assert t_res.Watchdog.is_stalled(str(tmp_path / "none.json"))

    from v2ap_torch.training.trainer import make_tx
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_tx(t_config.TrainConfig(learning_rate=1e-2, warmup_steps=1),
                  [p])
    guard = t_res.GradGuard(max_consecutive_skips=3)
    p.grad = torch.full((3,), float("nan"))
    assert guard.apply(opt, torch.tensor(1.0)) is False
    assert torch.isfinite(p).all() and guard.skipped == 1
    p.grad = torch.ones(3)
    assert guard.apply(opt, torch.tensor(1.0)) is True
    p.grad = torch.ones(3)
    assert guard.apply(opt, torch.tensor(float("inf"))) is False
    with pytest.raises(RuntimeError, match="diverged"):
        for _ in range(3):
            p.grad = torch.full((3,), float("nan"))
            guard.apply(opt, torch.tensor(1.0))


def test_stage_timer_metrics_logger_and_profile_trace(tmp_path):
    """The span recorder that took StageTimer's place (seconds by span
    name, summed over a call's spans), and the metrics file (tensors logged as floats) and a latent figure where
    matplotlib imports. The Chrome trace file writer went: a profiled run
    carries the recorder's spans (tests/test_torch_spans.py)."""
    import time

    from v2ap_torch.utils import observability as t_obs

    rec = t_obs.SpanRecorder("cpu")
    with rec.call():
        for _ in range(2):
            with rec.span("decode"):
                pass
        with rec.span("sample"):
            time.sleep(0.01)
    spans = rec.resolve()
    assert [s.name for s in spans] == ["decode", "decode", "sample"]
    totals = rec.totals()
    assert totals["sample"] >= 0.01
    assert totals["decode"] == sum(s.seconds for s in spans[:2])
    logger = t_obs.MetricsLogger(str(tmp_path / "logs"),
                                 use_tensorboard=False)
    logger.log(3, loss=torch.tensor(1.5), flow=2)
    logger.log_spectrogram(3, "pred", torch.randn(10, 8))
    logger.close()
    recs = [json.loads(line)
            for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert recs[0]["step"] == 3 and recs[0]["loss"] == 1.5
    try:
        import matplotlib  # noqa: F401
        assert os.path.exists(tmp_path / "logs" / "pred_3.png")
    except ImportError:
        pass
