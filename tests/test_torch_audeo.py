"""The port's Audeo piano subsystem (``v2ap_torch/audeo/``) against the JAX
package's on the CPU in float32, with the JAX models' weights carried
across: BatchNorm in training mode against flax's, Roll2Midi's generator
(plain and enhance) and discriminator in eval and train mode, one
``Roll2MidiTrainer`` and one ``Video2RollTrainer`` step, Adam against
optax, the datasets, the chunked inference helpers and their npz files, the
roll metrics, note extraction, synthesis, the MIDI file writer and the
keyboard crop registry.

Tolerances: network outputs, losses, updated parameters and running
statistics within 1e-4 relative RMS per tensor (f32 convolutions in another
summation order); gradients against the float64 gradient, within 1e-3 or
within twice the JAX package's float32 error, whichever is larger, and
against JAX's gradient (and JAX's against float64) within 2e-2, per tensor
(``_assert_grads_close``); BatchNorm's running statistics against flax's within
1e-6 absolute (torch's momentum or unbiased variance would miss that by
more than 1e-4); Adam against optax within 1e-6 relative; everything on
the host (samplers, pairs, rolls, notes, audio, metrics, MIDI bytes, the
registry) exactly equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from tests.test_torch_models import rel_rms
from tests.test_torch_ops import N, T, flatten_jax
from tests.test_torch_video2roll import randomize_params_and_stats
import v2ap_torch.audeo as ta
import v2ap_tpu.audeo as ja
from v2ap_torch.audeo import datasets as t_ds
from v2ap_torch.audeo import piano_coords as t_coords
from v2ap_torch.audeo import roll2midi as t_r2m
from v2ap_torch.audeo import train as t_train
from v2ap_torch.models import video2roll as t_v2r
from v2ap_torch.ops.layers import BatchNorm2d, Dropout
from v2ap_torch.utils.convert import _target, load_jax_params
from v2ap_tpu.audeo import datasets as j_ds
from v2ap_tpu.audeo import piano_coords as j_coords
from v2ap_tpu.audeo import roll2midi as j_r2m
from v2ap_tpu.models import video2roll as j_v2r

torch.set_num_threads(2)

REL_RMS = 1e-4
# a float32 gradient against the float64 one: the port reads up to 4.5e-3
# through the batch-statistics BatchNorms; of the tensors over 1e-3, the
# enhance discriminator's first bias comes closest to twice JAX's error
# (1.07e-3 against 5.4e-4)
GRAD_F64_RTOL = 1e-3
# JAX's float32 gradient against the float64 one and the port's against
# JAX's, per tensor: read up to 1.09e-2 and 1.35e-2 (the enhance
# generator's attention-gate biases); a gradient-only fault reads O(1)
GRAD_JAX_MAX = 2e-2
KEYS = 51


def _port_state(jax_model, port_cls, *args, **kw):
    """A port model holding ``jax_model``'s current parameters and
    statistics."""
    model = port_cls(*args, device="cpu", **kw)
    load_jax_params(model, flatten_jax(jax_model))
    return model


def _assert_states_close(got: torch.nn.Module, want: torch.nn.Module):
    """Every parameter and buffer (the counters of a torch BatchNorm
    excepted) within REL_RMS relative RMS, tensor by tensor."""
    a, b = got.state_dict(), want.state_dict()
    assert set(a) == set(b)
    bad = {k: rel_rms(N(a[k]), N(b[k])) for k in a
           if rel_rms(N(a[k]), N(b[k])) >= REL_RMS}
    assert not bad, bad


def test_exports_match_jax():
    names = lambda m: {n for n in dir(m) if not n.startswith("_")}
    assert names(ta) == names(ja)


# ---------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("eps", [1e-5, 0.8])
def test_batchnorm_train_matches_flax(eps):
    """Training mode against ``nnx.BatchNorm(use_running_average=False)``
    on an (2, 3, 3, 4) NHWC batch (18 values a channel, so the unbiased
    variance is 18/17 of the biased): output 1e-5, running statistics after
    two calls 1e-6. Torch's ``BatchNorm2d`` defaults (momentum 0.1, the
    unbiased running variance) land more than 1e-4 away."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(2, 3, 3, 4)).astype(np.float32) * 2 + 1
          for _ in range(2)]
    jbn = nnx.BatchNorm(4, epsilon=eps, dtype=jnp.float32,
                        use_running_average=False, rngs=nnx.Rngs(0))
    jbn.scale[...] = jnp.asarray(rng.normal(size=4), jnp.float32)
    jbn.bias[...] = jnp.asarray(rng.normal(size=4), jnp.float32)
    tbn = BatchNorm2d(4, eps=eps, device="cpu")
    load_jax_params(tbn, {"scale": np.asarray(jbn.scale[...]),
                          "bias": np.asarray(jbn.bias[...]),
                          "mean": np.zeros(4), "var": np.ones(4)})
    default = torch.nn.BatchNorm2d(4, eps=eps)
    for x in xs:
        want = np.asarray(jbn(jnp.asarray(x)))
        got = tbn(T(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
        np.testing.assert_allclose(N(got), want, atol=1e-5)
        default(T(x).permute(0, 3, 1, 2))
    for mine, theirs, ours in (
            (tbn.running_mean, default.running_mean, jbn.mean[...]),
            (tbn.running_var, default.running_var, jbn.var[...])):
        np.testing.assert_allclose(N(mine), np.asarray(ours), atol=1e-6)
        assert np.abs(N(theirs) - np.asarray(ours)).max() > 1e-4
    # eval mode: the running statistics
    x = T(xs[0]).permute(0, 3, 1, 2)
    np.testing.assert_allclose(
        N(tbn(x).permute(0, 2, 3, 1)),
        np.asarray(jbn(jnp.asarray(xs[0]), use_running_average=True)),
        atol=1e-5)


def test_batchnorm_train_takes_gradients_through_the_batch_statistics():
    """The normalised batch is invariant to a shift of the input, so the
    gradient of any loss through the batch mean cancels it: the input
    gradient sums to zero over each channel (it would not with the running
    statistics)."""
    bn = BatchNorm2d(3, device="cpu")
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    bn(x, train=True).pow(3).sum().backward()
    assert x.grad.sum(dim=(0, 2, 3)).abs().max() < 1e-3
    assert bn.running_mean.grad is None


# ---------------------------------------------------------------- Roll2Midi

def _gen_pair(enhance: bool, seed: int):
    jm = j_r2m.Roll2MidiGenerator(enhance=enhance, rngs=nnx.Rngs(seed))
    randomize_params_and_stats(jm, seed)
    return jm, _port_state(jm, t_r2m.Roll2MidiGenerator, enhance=enhance)


def _windows(seed, b=2, keys=8, frames=12):
    rng = np.random.default_rng(seed)
    roll = rng.random((b, keys, frames, 1)).astype(np.float32)
    return roll, (roll > 0.7).astype(np.float32)


@pytest.mark.parametrize("enhance", [False, True], ids=["plain", "enhance"])
def test_generator_matches_jax(enhance):
    """Eval mode (running statistics) and train mode (batch statistics,
    dropout off), then the running statistics after the train call."""
    jm, tm = _gen_pair(enhance, 1)
    roll, _ = _windows(2)
    # each call one compiled program (eager dispatch compiles every
    # primitive); train mode updates jm's statistics as the eager call does
    run = nnx.jit(lambda m, x, train: m(x, train=train),
                  static_argnames="train")
    want = np.asarray(run(jm, jnp.asarray(roll), False))
    with torch.no_grad():
        got = tm(T(roll))
    assert got.shape == want.shape == roll.shape
    assert rel_rms(N(got), want) < REL_RMS
    want = np.asarray(run(jm, jnp.asarray(roll), True))
    with torch.no_grad():
        got = tm(T(roll), train=True)
    assert rel_rms(N(got), want) < REL_RMS
    _assert_states_close(tm, _port_state(jm, t_r2m.Roll2MidiGenerator,
                                         enhance=enhance))


def test_discriminator_matches_jax():
    jm = j_r2m.Roll2MidiDiscriminator(height=17, width=25,
                                      rngs=nnx.Rngs(3))
    randomize_params_and_stats(jm, 3)
    tm = _port_state(jm, t_r2m.Roll2MidiDiscriminator, height=17, width=25)
    assert tm.output_shape == jm.output_shape == (3, 4, 1)
    roll, _ = _windows(4, keys=17, frames=25)
    want = np.asarray(jm(jnp.asarray(roll)))
    with torch.no_grad():
        got = tm(T(roll))
    assert got.shape == want.shape == (2, 3, 4, 1)     # (17, 25) -> (3, 4)
    assert rel_rms(N(got), want) < REL_RMS


def test_dropout_draws_from_the_generators_own_generator():
    """Train mode with dropout: the same ``dropout_seed`` gives the same
    output, another seed another one; eval mode draws nothing."""
    roll, _ = _windows(5)
    outs = []
    for seed in (0, 0, 1):
        torch.manual_seed(0)
        gen = t_r2m.Roll2MidiGenerator(device="cpu", dropout_seed=seed)
        with torch.no_grad():
            outs.append(N(gen(T(roll), train=True, deterministic=False)))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])
    state = gen.dropout_generator.get_state()
    with torch.no_grad():
        gen(T(roll))
    assert torch.equal(state, gen.dropout_generator.get_state())


def _no_dropout(gen):
    for name in ("down3", "down4", "down5", "down6", "up1", "up2"):
        getattr(gen, name).dropout.rate = 0.0


def _jax_grads(model, loss_fn) -> dict:
    """{dotted path: gradient} of ``loss_fn`` at a JAX model's parameters,
    compiled as one program (eager dispatch compiles every primitive)."""
    grads = nnx.jit(nnx.grad(loss_fn))(model)
    return {".".join(map(str, p)): np.asarray(v[...])
            for p, v in nnx.to_flat_state(grads)}


def _float64(model_cls, f32_model, **kw):
    """A float64 copy of a port model (every layer computing in float64;
    the few outputs cast to float32 on purpose round at 1e-7), for the
    exact gradients."""
    model = model_cls(device="cpu", **kw)
    model.load_state_dict(f32_model.state_dict())
    model.double()
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def _f64_grads(model, loss) -> dict:
    loss(model).backward()
    return {k: N(p.grad).astype(np.float64)
            for k, p in model.named_parameters()}


def _assert_grads_close(model: torch.nn.Module, jax_grads: dict,
                        exact: dict):
    """Each ``.grad`` of the port model against ``exact``, the float64
    gradient of the same loss, and against JAX's gradient, per tensor, in
    RMS relative to the exact gradient's RMS (taken at least 1e-3 of the
    model's, for a tensor whose exact gradient is zero: a conv bias in
    front of a batch-statistics BatchNorm):

    - the port's error against float64 at most 1e-3 or twice JAX's float32
      error, whichever is larger: the port is as exact as JAX;
    - JAX's error against float64, and the port against JAX, each at most
      GRAD_JAX_MAX: the float64 reference is JAX's gradient, so a fault
      that the port's float32 and float64 copies share (a detached
      BatchNorm mean) fails here instead of widening the first limit.

    Through a batch-statistics BatchNorm at batch 2, float32 resolves the
    early layers' gradients to ~3e-3 only, in both packages."""
    params = dict(model.named_parameters())
    rms = lambda a: float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))
    total = rms(np.concatenate([g.ravel() for g in exact.values()]))
    seen, bad = set(), {}
    for key, gj in jax_grads.items():
        name, transform = _target(model, key)
        ge = exact[name]
        scale = max(rms(ge), 1e-3 * total)
        port = rms(N(params[name].grad) - ge) / scale
        jax_err = rms(transform(gj) - ge) / scale
        direct = rms(N(params[name].grad) - transform(gj)) / scale
        if not (port <= max(GRAD_F64_RTOL, 2.0 * jax_err)
                and jax_err <= GRAD_JAX_MAX and direct <= GRAD_JAX_MAX):
            bad[name] = (port, jax_err, direct)
        seen.add(name)
    assert seen == set(params)
    assert not bad, bad


def _assert_adam_first_step(model: torch.nn.Module, before: dict, lr: float):
    """The parameters moved by optax's first Adam update of their own
    gradient: -lr g / (|g| + 1e-8) (the bias corrections cancel)."""
    for name, p in model.named_parameters():
        g = N(p.grad)
        want = N(before[name]) - lr * g / (np.abs(g) + 1e-8)
        np.testing.assert_allclose(N(p), want, rtol=1e-6, atol=1e-9,
                                   err_msg=name)


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


@pytest.mark.parametrize("enhance", [False, True], ids=["plain", "enhance"])
def test_roll2midi_step_matches_jax(enhance):
    """One ``Roll2MidiTrainer.step`` (G update in train mode, then D on the
    updated G in eval mode) from the same weights, every dropout rate 0 on
    both instances, against JAX's trainer: the four losses, G's and D's
    gradients against JAX's (D's at the port's updated G, which both
    packages' D losses then read), the Adam update of them (lr 5e-4 and
    1e-3), and G's running statistics after the step.
    The updated parameters are not compared with JAX's element by element:
    Adam's first update is +-lr wherever |g| >> 1e-8, so an element whose
    gradient is at rounding level in both packages may move 2 lr apart."""
    jg, tg = _gen_pair(enhance, 6)
    jd = j_r2m.Roll2MidiDiscriminator(height=8, width=12, rngs=nnx.Rngs(7))
    randomize_params_and_stats(jd, 7)
    td = _port_state(jd, t_r2m.Roll2MidiDiscriminator, height=8, width=12)
    _no_dropout(jg)
    _no_dropout(tg)
    jg0, jd0 = nnx.clone(jg), nnx.clone(jd)
    g_before, d_before = _params(tg), _params(td)
    g64 = _float64(t_r2m.Roll2MidiGenerator, tg, enhance=enhance)
    d64 = _float64(t_r2m.Roll2MidiDiscriminator, td, height=8, width=12)
    roll, gt = _windows(8)
    want = ja.Roll2MidiTrainer(jg, jd).step(roll, gt)
    got = t_train.Roll2MidiTrainer(tg, td).step(roll, gt)
    g_terms = [0, 2, 3]                         # G loss, adversarial, rec
    assert rel_rms(np.take(got, g_terms), np.take(want, g_terms)) < REL_RMS
    # D's loss is of each package's updated G, which Adam's +-lr moves
    # apart (see above; read 2.3e-3 relative): against JAX only to 1e-2,
    # and to 1e-4 against float64 on the port's updated G below
    assert abs(got[1] - want[1]) < 1e-2 * want[1]

    w = t_train.ADV_WEIGHT

    def g_loss(g):
        fake = g(jnp.asarray(roll), train=True, deterministic=False)
        return (w * jnp.mean((jd0(fake) - 1.0) ** 2)
                + (1 - w) * jnp.mean((fake - jnp.asarray(gt)) ** 2))

    # D's gradient at the port's updated G (eval mode), the fake that the
    # port's D step saw, so that both packages' D gradients have one input
    with torch.no_grad():
        fake = jnp.asarray(N(tg(T(roll))))

    def d_loss(d):
        return 0.5 * (jnp.mean((d(jnp.asarray(gt)) - 1.0) ** 2)
                      + jnp.mean(d(fake) ** 2))

    assert abs(got[1] - float(d_loss(jd0))) < REL_RMS * got[1]
    roll64, gt64 = T(roll).double(), T(gt).double()

    def g_loss64(g):
        fake = g(roll64, train=True).double()
        return (w * (d64(fake) - 1.0).pow(2).mean()
                + (1 - w) * (fake - gt64).pow(2).mean())

    g_exact = _f64_grads(g64, g_loss64)
    d64.zero_grad(set_to_none=True)
    fake64 = T(np.asarray(fake)).double()       # the same fake, in float64
    d_loss64 = lambda d: 0.5 * ((d(gt64) - 1.0).pow(2).mean()
                                + d(fake64).pow(2).mean())
    with torch.no_grad():
        assert abs(got[1] - d_loss64(d64).item()) < REL_RMS * got[1]
    d_exact = _f64_grads(d64, d_loss64)
    _assert_grads_close(tg, _jax_grads(jg0, g_loss), g_exact)
    _assert_grads_close(td, _jax_grads(jd0, d_loss), d_exact)
    _assert_adam_first_step(tg, g_before, 5e-4)
    _assert_adam_first_step(td, d_before, 1e-3)
    ref = _port_state(jg, t_r2m.Roll2MidiGenerator, enhance=enhance)
    for name, buf in tg.named_buffers():
        assert rel_rms(N(buf), N(ref.get_buffer(name))) < REL_RMS, name


# --------------------------------------------------------------- Video2Roll

def test_video2roll_step_matches_jax():
    """One ``Video2RollTrainer`` step at batch 2 of real 5 x 100 x 900
    windows against JAX's trainer: the loss, the logits, the gradients
    (JAX's of the same loss), the Adam update of them (lr 1e-3) and every
    BatchNorm running statistic (see the Roll2Midi step for why the updated
    parameters are held through their gradients)."""
    jm = j_v2r.Video2RollNet(rngs=nnx.Rngs(9))
    randomize_params_and_stats(jm, 9)
    tm = _port_state(jm, t_v2r.Video2RollNet)
    jm0, before = nnx.clone(jm), _params(tm)
    m64 = _float64(t_v2r.Video2RollNet, tm)
    rng = np.random.default_rng(10)
    frames = rng.random((2, 5, 100, 900)).astype(np.float32)
    labels = (rng.random((2, KEYS)) > 0.8).astype(np.float32)
    jt = ja.Video2RollTrainer(jm)
    want_loss, want_logits = jt._step(jm, jt.optimizer, jnp.asarray(frames),
                                      jnp.asarray(labels))
    loss, logits = ta.Video2RollTrainer(tm).step(frames, labels)
    assert abs(float(loss) - float(want_loss)) < REL_RMS * float(want_loss)
    assert rel_rms(N(logits), np.asarray(want_logits)) < REL_RMS

    def loss_fn(m):
        return optax.sigmoid_binary_cross_entropy(
            m(jnp.asarray(frames), train=True), jnp.asarray(labels)).mean()

    exact = _f64_grads(m64, lambda m: F.binary_cross_entropy_with_logits(
        m(T(frames).double(), train=True).double(), T(labels).double()))
    _assert_grads_close(tm, _jax_grads(jm0, loss_fn), exact)
    _assert_adam_first_step(tm, before, 1e-3)
    ref = _port_state(jm, t_v2r.Video2RollNet)
    for name, buf in tm.named_buffers():
        assert rel_rms(N(buf), N(ref.get_buffer(name))) < REL_RMS, name


def test_video2roll_epochs_count_bad_epochs_as_jax():
    """``train_epoch``: the mean loss of its steps, ``max_steps``, and the
    bad-epoch counter (an epoch no better than the last), which changes no
    learning rate; each step stubbed with the same losses in both
    packages."""
    losses = [3.0, 1.0, 2.0, 2.0, 1.5, 1.5, 0.5, 0.5]
    batch = (np.zeros((1, 5, 4, 4), np.float32), np.zeros((1, KEYS)))
    jt = ja.Video2RollTrainer.__new__(ja.Video2RollTrainer)
    tt = ta.Video2RollTrainer.__new__(ta.Video2RollTrainer)
    for tr in (jt, tt):
        tr.model = tr.optimizer = None
        tr.history, tr._bad_epochs = [], 0
    j_it, t_it = iter(losses), iter(losses)
    jt._step = lambda *a: (next(j_it), None)
    tt.step = lambda *a: (torch.tensor(next(t_it)), None)
    for max_steps in (2, 2, 3, None):
        n = 1 if max_steps is None else max_steps
        assert tt.train_epoch(iter([batch] * n), max_steps=max_steps) == \
            jt.train_epoch(iter([batch] * n), max_steps=max_steps)
        assert tt._bad_epochs == jt._bad_epochs
    assert tt.history == jt.history == [2.0, 2.0, 1.1666666666666667, 0.5]
    assert tt._bad_epochs == 0


def test_video2roll_net_train_flag_matches_jax():
    """``Video2RollNet(x, train=True)``: logits from the batch statistics
    and the running statistics after the call, against JAX's."""
    jm = j_v2r.Video2RollNet(rngs=nnx.Rngs(11))
    randomize_params_and_stats(jm, 11)
    tm = _port_state(jm, t_v2r.Video2RollNet)
    x = np.random.default_rng(12).random((2, 5, 100, 900)).astype(np.float32)
    # one compiled program (eager dispatch compiles every primitive); the
    # batch statistics update jm as the eager call does
    want = np.asarray(nnx.jit(lambda m, x: m(x, train=True))(
        jm, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(T(x), train=True)
    assert rel_rms(N(got), want) < REL_RMS
    _assert_states_close(tm, _port_state(jm, t_v2r.Video2RollNet))


def test_adam_matches_optax():
    """The trainers' Adam (``torch.optim.Adam``, eps 1e-8) against
    ``optax.adam`` over three steps of seeded gradients, some elements at
    zero and some at 1e-9 (where eps outside the square root matters)."""
    rng = np.random.default_rng(13)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3)]
    grads[0][0] = 0.0
    grads[1][1] = 1e-9
    tx = optax.adam(5e-4, b1=0.9, b2=0.999)
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    param = torch.nn.Parameter(T(p0))
    opt = t_train._adam([param], 5e-4)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = T(g)
        opt.step()
    np.testing.assert_allclose(N(param), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)


# ----------------------------------------------------------------- datasets

def test_video2roll_samples_match_jax():
    rng = np.random.default_rng(14)
    frames = rng.random((40, 16, 32)).astype(np.float32)
    labels = np.zeros((40, KEYS))
    labels[5, 3] = 1
    labels[:, 30] = 1
    labels[rng.random((40, KEYS)) > 0.95] = 1
    jb = ja.Video2RollSamples(frames, labels, seed=3).balanced_batches(16)
    tb = ta.Video2RollSamples(frames, labels, seed=3).balanced_batches(16)
    for _ in range(3):
        (js, jl), (ts, tl) = next(jb), next(tb)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tl, jl)


class _FakeV2R(torch.nn.Module):
    """Logits from the middle frame, exactly representable: x * 8 - 4 on
    the first 51 columns of the first row."""

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return x[:, 2, 0, :KEYS] * 8.0 - 4.0


def _read_npz(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        with np.load(os.path.join(folder, name)) as data:
            out[name] = {k: data[k] for k in data.files}
    return out


def test_video2roll_infer_chunks_match_jax(tmp_path):
    """120 frames (chunks of 50, 50, 20): the (start, end, logit, roll)
    tuples and the npz files equal JAX's, through a deterministic stand-in
    net; then the real Video2RollNet on 60 5 x 100 x 900 windows with the
    same weights: logits within 1e-4, rolls equal where the probability is
    not within 1e-4 of the threshold."""
    frames = np.random.default_rng(15).random((120, 8, 64)
                                              ).astype(np.float32)
    want = j_ds.video2roll_infer_chunks(
        lambda x: x[:, 2, 0, :KEYS] * 8.0 - 4.0, frames,
        out_dir=str(tmp_path / "j"))
    got = t_ds.video2roll_infer_chunks(_FakeV2R(), frames,
                                       out_dir=str(tmp_path / "t"))
    assert [r[:2] for r in got] == [r[:2] for r in want] == \
        [(0, 50), (50, 100), (100, 120)]
    for (_, _, gl, gr), (_, _, wl, wr) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gr, wr)
        assert gl.dtype == wl.dtype and gr.dtype == wr.dtype
    jf, tf = _read_npz(tmp_path / "j"), _read_npz(tmp_path / "t")
    assert list(tf) == list(jf) == ["0-50.npz", "100-120.npz", "50-100.npz"]
    for name in jf:
        for key in ("logit", "roll"):
            np.testing.assert_array_equal(tf[name][key], jf[name][key])

    jm = j_v2r.Video2RollNet(rngs=nnx.Rngs(16))
    randomize_params_and_stats(jm, 16)
    tm = _port_state(jm, t_v2r.Video2RollNet)
    strips = np.random.default_rng(17).random((60, 100, 900)
                                              ).astype(np.float32)
    # the net as one compiled program (eager dispatch compiles every
    # primitive)
    fwd = nnx.jit(lambda m, x: m(x))
    want = j_ds.video2roll_infer_chunks(lambda x: fwd(jm, x), strips)
    got = t_ds.video2roll_infer_chunks(tm, strips)
    for (_, _, gl, gr), (_, _, wl, wr) in zip(got, want):
        assert rel_rms(gl, wl) < REL_RMS
        prob = 1.0 / (1.0 + np.exp(-wl))
        clear = np.abs(prob - 0.4) > 1e-4
        np.testing.assert_array_equal(gr[clear], wr[clear])


def test_roll2midi_pairs_and_chunk_dir_match_jax(tmp_path):
    """Five chunks (the odd last one dropped, as JAX's range(0, len - 1, 2)
    drops it): the windows, three seeded batches, and the chunk directory
    read back in start order."""
    rng = np.random.default_rng(18)
    logits = [rng.normal(size=(50, 88)).astype(np.float32) for _ in range(5)]
    rolls = [(rng.random((50, 88)) > 0.8).astype(np.int64) for _ in range(5)]
    jp, tp = ja.Roll2MidiPairs(logits, rolls), ta.Roll2MidiPairs(logits, rolls)
    assert len(tp) == len(jp) == 2
    for (tr, tg), (jr, jg) in zip(tp.windows, jp.windows):
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tg, jg)
    jb, tb = jp.batches(3, seed=4), tp.batches(3, seed=4)
    for _ in range(3):
        for a, b in zip(next(tb), next(jb)):
            np.testing.assert_array_equal(a, b)
    folder = tmp_path / "chunks"
    folder.mkdir()
    for i, (lg, rl) in enumerate(zip(logits, rolls)):
        np.savez(folder / f"{i * 50}-{(i + 1) * 50}.npz", logit=lg, roll=rl)
    for a, b in zip(ta.load_roll_chunk_dir(str(folder)),
                    ja.load_roll_chunk_dir(str(folder))):
        assert len(a) == len(b) == 5
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


class _FakeGen(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return 1.0 - x


def test_roll2midi_infer_matches_jax(tmp_path):
    """Five chunks through a deterministic stand-in generator (1 - p): the
    midi chunks and their npz files equal JAX's (the odd last chunk
    dropped)."""
    rng = np.random.default_rng(19)
    logits = [rng.normal(size=(50, 88)).astype(np.float32) for _ in range(5)]
    want = j_ds.roll2midi_infer(lambda x: 1.0 - x, logits,
                                out_dir=str(tmp_path / "j"))
    got = t_ds.roll2midi_infer(_FakeGen(), logits,
                               out_dir=str(tmp_path / "t"))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int64
    jf, tf = _read_npz(tmp_path / "j"), _read_npz(tmp_path / "t")
    assert list(tf) == list(jf)
    for name in jf:
        np.testing.assert_array_equal(tf[name]["midi"], jf[name]["midi"])


def test_roll2midi_infer_with_the_generator_matches_jax():
    """The real generator (plain) on two chunks, same weights: the cleaned
    midi equal where G's output is not within 1e-4 of the threshold."""
    jm, tm = _gen_pair(False, 20)
    logits = [np.random.default_rng(21).normal(size=(50, 88)
                                                ).astype(np.float32)
              for _ in range(2)]
    probe = {}

    fwd = nnx.jit(lambda g, x: g(x))     # one compiled program

    def j_fn(g, x):
        probe["j"] = np.asarray(fwd(g, x))
        return probe["j"]

    def t_fn(g, x):
        with torch.no_grad():
            out = g(x)
        probe["t"] = N(out)
        return out

    want = j_ds.roll2midi_infer(jm, logits, batch_fn=j_fn)
    got = t_ds.roll2midi_infer(tm, logits, batch_fn=t_fn)
    assert rel_rms(probe["t"], probe["j"]) < REL_RMS
    clear = (np.abs(probe["j"][0, ..., 0].T - 0.4) > 1e-4)
    for j, (a, b) in enumerate(zip(got, want)):
        rows = clear[j * 50:(j + 1) * 50]
        np.testing.assert_array_equal(a[:, 15:66][rows], b[:, 15:66][rows])


# ------------------------------------------------------ synthesis, metrics

def _roll(seed, frames=60, keys=KEYS):
    return (np.random.default_rng(seed).random((frames, keys)) > 0.85
            ).astype(np.int64)


def test_roll_to_notes_and_synthesis_match_jax():
    roll = _roll(22)
    notes = ta.roll_to_notes(roll)
    assert notes == ja.roll_to_notes(roll)
    np.testing.assert_array_equal(ta.synthesize_notes(notes),
                                  ja.synthesize_notes(notes))
    np.testing.assert_array_equal(ta.synthesize_notes({}),
                                  ja.synthesize_notes({}))


def test_midi_file_bytes_equal_jax(tmp_path):
    notes = ja.roll_to_notes(_roll(23))
    ta.write_midi_file(str(tmp_path / "t.mid"), notes)
    ja.write_midi_file(str(tmp_path / "j.mid"), notes)
    data = (tmp_path / "t.mid").read_bytes()
    assert data == (tmp_path / "j.mid").read_bytes()
    assert data[:4] == b"MThd" and data[14:18] == b"MTrk"


def test_midi_synth_reads_chunk_dirs_as_jax(tmp_path):
    """``MidiSynth``: a chunk directory (a short last chunk padded) read
    into one roll, then synthesized."""
    rng = np.random.default_rng(24)
    for start, end in ((0, 50), (50, 100), (100, 130)):
        np.savez(tmp_path / f"{start}-{end}.npz",
                 roll=(rng.random((end - start, 88)) > 0.9).astype(np.int64))
    t_roll = ta.MidiSynth().rolls_from_npz_dir(str(tmp_path))
    j_roll = ja.MidiSynth().rolls_from_npz_dir(str(tmp_path))
    np.testing.assert_array_equal(t_roll, j_roll)
    np.testing.assert_array_equal(
        ta.MidiSynth().synthesize_roll(t_roll[:40], min_key=0),
        ja.MidiSynth().synthesize_roll(j_roll[:40], min_key=0))


def test_roll_metrics_match_jax():
    rng = np.random.default_rng(25)
    pred, gt = rng.random((80, KEYS)), (rng.random((80, KEYS)) > 0.7)
    assert ta.evaluate_rolls(pred, gt).as_dict() == \
        ja.evaluate_rolls(pred, gt).as_dict()
    np.testing.assert_array_equal(ta.evaluate_per_key(pred, gt),
                                  ja.evaluate_per_key(pred, gt))
    empty = np.zeros((4, KEYS))
    assert ta.evaluate_rolls(empty, empty) == \
        ta.RollMetrics(0.0, 0.0, 0.0, 0.0, 0, 0, 0)


def test_piano_coords_registry_equals_jax(tmp_path):
    """The port's registry (its own copy of the data file, read on first
    use) holds the JAX package's boxes, and the reference's raw boxes are
    the same; a registered box round-trips through save / load."""
    ids = [f"train_{i:02d}" for i in range(24)] + \
        [f"test_{i:02d}" for i in range(3)]
    for vid in ids:
        assert t_coords.get(vid) == j_coords.get(vid) is not None
    assert t_coords.get("train_24") is None
    for split in ("train", "test"):
        assert t_coords.reference_boxes(split) == \
            j_coords.reference_boxes(split)
    frames = np.zeros((2, 900, 1920, 3), np.uint8)
    box = t_coords.get("test_01")
    assert t_coords.crop_keyboard(frames, box).shape == \
        j_coords.crop_keyboard(frames, box).shape
    t_coords.register("clip_x", (1, 2, 3, 4))
    path = str(tmp_path / "reg.json")
    t_coords.save_registry(path)
    assert j_coords.load_registry(path) == len(ids) + 1
    assert j_coords.get("clip_x") == (1, 2, 3, 4)
