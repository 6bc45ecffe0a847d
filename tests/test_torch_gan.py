"""The port's vocoder GAN training block against ``ttsx`` on the CPU:
spectral norm, ``SNConv``, the period / scale / band discriminators,
the STFT loss, the GAN losses, R1, and ``VocoderBlock``'s discriminator
and generator steps (same weights from ``init_like``, same draws: see
torch_train_helpers.py). Then the port's own rules: the length rule on
collated batches, the engine's dynamic D:G ratio, ``vocoder_freeze_until``
and OOM skip, and the slim export both ways.

Tolerances: module outputs 1e-5 relative + 1e-6 absolute; losses 1e-5
relative; gradients read from Adam's first moment (0.1 x the gradient
after an update from zero moments) 1e-4 relative + 2e-8 absolute, as in
the trainer's parity tests, so gradients taken directly 1e-4 relative +
2e-7 absolute."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_parity_helpers import init_like, randn, to_numpy
from torch_train_helpers import (JaxDraws, TINY_VOCODER, _numpy,
                                 close_metrics, close_tree, gan_cfg, jax_cfg,
                                 mu_tree)

from ttsx_torch.nn.draws import ReplayDraws
from ttsx_torch.weights import from_flax, load_flax

# torch on one thread: six workers share the cores (torch_parity_helpers)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
MU_TOL = dict(rtol=1e-4, atol=2e-8)
GRAD_TOL = dict(rtol=1e-4, atol=2e-7)
JVC = jax_cfg(gan_cfg()).vocoder


def close(got, ref, tol=OUT_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol)


def wav(seed, B=2, T=1027, tail=0):
    """[B, T, 1] noise with its last ``tail`` samples zero."""
    w = randn(seed, B, T, 1, scale=0.3)
    if tail:
        w[:, -tail:] = 0.0
    return w


# ------------------------------------------------------- spectral norm, SNConv
@pytest.mark.parametrize("shape", [(15, 4, 8), (5, 1, 16, 4)],
                         ids=["1d", "2d"])
def test_spectral_normalize_value_and_gradient(shape):
    from ttsx.nn.conv import spectral_normalize as jsn
    from ttsx_torch.nn.conv import spectral_normalize
    w, r = randn(0, *shape), randn(1, *shape)
    ref, jgrad = jax.value_and_grad(
        lambda x: jnp.sum(jsn(x) * r))(jnp.asarray(w))
    tw = torch.tensor(w, requires_grad=True)
    got = (spectral_normalize(tw) * torch.as_tensor(r)).sum()
    got.backward()
    assert float(got.detach()) == pytest.approx(float(ref), rel=1e-5)
    close(tw.grad, jgrad, GRAD_TOL)


@pytest.mark.parametrize("ks,strides,T", [((15,), (2,), 41), ((15,), (2,), 40),
                                          ((5, 1), (3, 1), 23),
                                          ((5, 1), (3, 1), 24)])
def test_snconv_matches_reference(ks, strides, T):
    from ttsx.nn.conv import SNConv as JSNConv
    from ttsx_torch.nn.conv import SNConv
    x = randn(0, 2, T, 3, 4) if len(ks) == 2 else randn(0, 2, T, 4)
    jm = JSNConv(8, kernel_size=ks, strides=strides)
    v = init_like(jm, jnp.asarray(x), seed=1)
    m = load_flax(SNConv(4, 8, ks, strides), to_numpy(v))
    got = m(torch.as_tensor(x).movedim(-1, 1)).movedim(1, -1)
    close(got, jm.apply(v, jnp.asarray(x)))


# ------------------------------------------------------------ discriminators
@pytest.mark.parametrize("name", ["mpd", "msd", "mbd"])
def test_discriminator_logits_and_features_match_reference(name):
    """T = 1027 is no multiple of the periods 2 and 3 nor of the 4 bands;
    the MSD's two SAME average pools pad odd lengths."""
    from ttsx.models import vocoder as jv
    from ttsx_torch.models import discriminators as pd
    cls = {"mpd": "MultiPeriodDiscriminator", "msd": "MultiScaleDiscriminator",
           "mbd": "MultiBandDiscriminator"}[name]
    vc = dataclasses.replace(TINY_VOCODER, disc_kernel_sizes=(15, 7, 5))
    jm = getattr(jv, cls)(jax_cfg(gan_cfg(disc_kernel_sizes=(15, 7, 5))
                                  ).vocoder)
    x = wav(0)
    v = init_like(jm, jnp.asarray(x), seed=2, scale=0.3)
    m = load_flax(getattr(pd, cls)(vc), to_numpy(v))
    logits, feats = m(torch.as_tensor(x))
    jl, jf = jm.apply(v, jnp.asarray(x))
    assert len(logits) == len(jl) and len(feats) == len(jf)
    for a, b in zip(logits, jl):
        assert a.shape == b.shape
        close(a, b)
    for fa, fb in zip(feats, jf):
        assert len(fa) == len(fb)
        for a, b in zip(fa, fb):
            assert a.shape == b.shape
            close(a, b)


def test_the_wide_scale_convs_alone_take_the_kernel():
    """At ``VocoderConfig()`` the shape rule of ``SNConv.fits_kernel`` (1-D,
    stride 1, odd k, at least 64 channels in and out, multiples of 4) picks
    exactly ``SNConv_3`` and ``SNConv_4`` of each scale discriminator: 6 of
    the 63 ``SNConv``s, read from the modules' shapes alone; a width that
    is no multiple of 4, in or out, keeps cuDNN."""
    from ttsx_torch.core.config import VocoderConfig
    from ttsx_torch.models import discriminators as pd
    from ttsx_torch.nn.conv import SNConv
    vc = VocoderConfig()
    picked, n = [], 0
    for name, cls in (("mpd", pd.MultiPeriodDiscriminator),
                      ("msd", pd.MultiScaleDiscriminator),
                      ("mbd", pd.MultiBandDiscriminator)):
        for sub, m in cls(vc).named_modules():
            if isinstance(m, SNConv):
                n += 1
                if m.fits_kernel:
                    picked.append(f"{name}.{sub}")
    assert n == 63
    assert sorted(picked) == [f"msd.scale_{i}.SNConv_{j}"
                              for i in range(3) for j in (3, 4)]
    assert SNConv(64, 68, (15,)).fits_kernel
    assert not SNConv(66, 128, (15,)).fits_kernel
    assert not SNConv(128, 66, (15,)).fits_kernel


def test_snconv_counts_its_flops_and_keeps_the_plain_path_on_the_cpu():
    """A forward adds 2 x outputs x Cin x k FLOPs to ``snconv.flops``, twice
    that when x will take a gradient; on the CPU none goes through the
    kernel, and the conv equals ``F.pad`` + ``F.conv1d``."""
    from ttsx_torch.nn.conv import SNConv, same_pads
    from ttsx_torch.utils.spans import recording
    conv = SNConv(64, 64, (5,))
    x = torch.as_tensor(randn(3, 2, 64, 11))
    with recording() as rec:
        y = conv(x)
        conv(x.clone().requires_grad_())
        with torch.no_grad():
            conv(x.clone().requires_grad_())
    one = 2.0 * y.numel() * 64 * 5
    assert rec.counters == {"snconv.flops": 4 * one}
    ref = torch.nn.functional.conv1d(
        torch.nn.functional.pad(x, same_pads(11, 5)),
        conv.normalized_weight(), conv.bias)
    assert conv.fits_kernel and torch.equal(y, ref)


def test_avg_pool_counts_padding_as_flax():
    import flax.linen as fnn
    from ttsx_torch.nn.conv import avg_pool1d
    for T in (9, 10):
        x = randn(T, 2, T, 3)
        close(avg_pool1d(torch.as_tensor(x), 4, 2),
              fnn.avg_pool(jnp.asarray(x), (4,), (2,), padding="SAME"))


# ------------------------------------------------------------------ STFT loss
def test_stft_loss_value_and_gradient_on_a_padded_wav():
    """A random filterbank, a fake wav whose tail is zero (frames that read
    only zeros): value and d/d wav_fake, with no NaN. The gradient's
    absolute tolerance is 1e-5 (largest element 0.39): the log term
    divides by magnitudes near its 1e-5 floor on the padded tail, and
    there the port and the reference are each up to 7e-6 and 3e-6 from a
    float64 computation of the same loss."""
    from ttsx.models.vocoder import STFTLoss as JSTFT
    from ttsx_torch.models.discriminators import STFTLoss
    vc = dataclasses.replace(TINY_VOCODER, stft_sizes=(256, 512))
    jm = JSTFT(dataclasses.replace(JVC, stft_sizes=(256, 512)))
    fake, real = wav(0, tail=600), wav(1)
    v = init_like(jm, jnp.asarray(fake), jnp.asarray(real), seed=3)
    m = load_flax(STFTLoss(vc), to_numpy(v))
    assert not list(m.parameters())       # the filterbank is frozen
    ref, jg = jax.value_and_grad(lambda f: jm.apply(v, f, jnp.asarray(real)))(
        jnp.asarray(fake))
    tf = torch.tensor(fake, requires_grad=True)
    got = m(tf, torch.as_tensor(real))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(ref), rel=1e-5)
    assert torch.isfinite(tf.grad).all()
    close(tf.grad, jg, dict(rtol=1e-4, atol=1e-5))


# ----------------------------------------------------------------- GAN losses
def test_gan_losses_match_reference():
    from ttsx.train import losses as JL
    from ttsx_torch.train import losses as L
    rng = np.random.default_rng(0)
    a = lambda *s: rng.normal(size=s).astype(np.float32)
    real = [a(2, 9, 1), a(2, 5, 2, 1), a(2, 3, 1)]
    fake = [a(2, 9, 1), a(2, 5, 2, 1), a(2, 3, 1)]
    ff = [[a(2, 9, 4), a(2, 4, 8)], [a(2, 5, 2, 4)]]
    rf = [[a(2, 9, 4), a(2, 4, 8)], [a(2, 5, 2, 4)]]
    T = lambda xs: [torch.as_tensor(x) for x in xs]
    J = lambda xs: [jnp.asarray(x) for x in xs]
    got = {"d": L.hinge_d_loss(T(real), T(fake)), "g": L.hinge_g_loss(T(fake)),
           "fm": L.feature_matching_loss([T(f) for f in ff],
                                         [T(r) for r in rf]),
           "energy": L.log_rms_energy_loss(torch.as_tensor(wav(0) * 0.5),
                                           torch.as_tensor(wav(1)))}
    ref = {"d": JL.hinge_d_loss(J(real), J(fake)), "g": JL.hinge_g_loss(J(fake)),
           "fm": JL.feature_matching_loss([J(f) for f in ff],
                                          [J(r) for r in rf]),
           "energy": JL.log_rms_energy_loss(jnp.asarray(wav(0) * 0.5),
                                            jnp.asarray(wav(1)))}
    close_metrics(got, ref, 1e-5, 0)
    for step in (0, 1, 80, 160, 1000):
        assert L.adversarial_warmup(step, 16) == pytest.approx(
            float(JL.adversarial_warmup(jnp.float32(step), 16)), rel=1e-6)
    # feature matching holds the real maps fixed
    f0, r0 = torch.tensor(ff[0][0], requires_grad=True), torch.tensor(
        rf[0][0], requires_grad=True)
    L.feature_matching_loss([[f0]], [[r0]]).backward()
    assert r0.grad is None and f0.grad is not None


@pytest.fixture(scope="module")
def discs():
    """Reference MPD and MSD at the tiny config with seeded weights, the
    port's copies, and a real wav."""
    from ttsx.models.vocoder import (MultiPeriodDiscriminator as JMPD,
                                     MultiScaleDiscriminator as JMSD)
    from ttsx_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                  MultiScaleDiscriminator)
    x = wav(5, T=700)
    out = {}
    for name, jcls, cls, seed in (("mpd", JMPD, MultiPeriodDiscriminator, 6),
                                  ("msd", JMSD, MultiScaleDiscriminator, 7)):
        jm = jcls(JVC)
        v = to_numpy(init_like(jm, jnp.asarray(x), seed=seed, scale=0.3))
        out[name] = (jm, v, load_flax(cls(TINY_VOCODER), v))
    return out, x


def test_r1_penalty_of_one_discriminator(discs):
    from ttsx.train import losses as JL
    from ttsx_torch.train import losses as L
    d, x = discs
    jm, v, m = d["mpd"]
    ref = JL.r1_penalty(jm.apply, v, jnp.asarray(x))
    got = L.r1_penalty(m, torch.as_tensor(x)).detach()
    assert float(got) == pytest.approx(float(ref), rel=1e-5)


def test_r1_term_and_its_gradients_match_reference(discs):
    """The block's R1: 0.5 * r1_gamma * the batch mean of ||d(sum of the
    MPD and MSD logits)/d wav||^2, and its gradient with respect to every
    MPD and MSD parameter, by double backward."""
    from ttsx_torch.train import losses as L
    d, x = discs
    (jmpd, vp, mpd), (jmsd, vs, msd) = d["mpd"], d["msd"]

    def r1(pp, ps):
        def score(w):
            l1, _ = jmpd.apply(pp, w)
            l2, _ = jmsd.apply(ps, w)
            return sum(jnp.sum(l) for l in l1 + l2)
        g = jax.grad(score)(jnp.asarray(x))
        return 0.5 * JVC.r1_gamma * jnp.mean(jnp.sum(g ** 2, axis=(1, 2)))

    ref, (gp, gs) = jax.jit(jax.value_and_grad(r1, argnums=(0, 1)))(vp, vs)
    w = torch.tensor(x, requires_grad=True)
    score = sum(l.sum() for l in mpd(w)[0] + msd(w)[0])
    got = 0.5 * JVC.r1_gamma * L.r1_from_scores(score, w)
    got.backward()
    got = got.detach()
    assert float(got) > 0
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    for m, g in ((mpd, gp), (msd, gs)):
        want = from_flax(m, _numpy(g))
        for n, p in m.named_parameters():
            # the logit layer's bias moves no logit's slope: no gradient
            grad = torch.zeros_like(p) if p.grad is None else p.grad
            close(grad, want[n], GRAD_TOL)


# ---------------------------------------------------------------- the block
def vocoder_trees(jb, batch, seed=0):
    """``init_like`` trees of the reference block's six parts; its
    ``init_state`` then returns them (no init compile).

    The generator's weights are drawn at scale 0.15, the discriminators'
    at 0.3. At ``init_like``'s 0.05 the generator's output is nearly
    constant: half its STFT bins lie below 1e-3 and some at the 1e-5
    floor of the STFT loss's log term, which multiplies f32 rounding by
    up to 1e5. At 0.3 its output saturates ``tanh``. Even at 0.15 the
    gradient of the full generator loss is f32-accurate only to about
    1e-3 of its largest element (see
    ``test_vocoder_block_steps_match_reference``); the adversarial term
    alone is held at 1e-4 (``test_gen_step_adversarial_gradient_...``)."""
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    style = jnp.zeros((b["mel"].shape[0], jb.cfg.vocoder.style_dim))
    trees = {
        "gen": init_like(jb.gen, b["mel"], b["prosody"], style,
                         b["emotion_probs"], seed=seed, scale=0.15),
        "gst": init_like(jb.gst, b["mel"], seed=seed + 1),
        "mpd": init_like(jb.mpd, b["wav"], seed=seed + 2, scale=0.3),
        "msd": init_like(jb.msd, b["wav"], seed=seed + 3, scale=0.3),
        "mbd": init_like(jb.mbd, b["wav"], seed=seed + 4, scale=0.3),
        "stft": init_like(jb.stft_loss, b["wav"], b["wav"], seed=seed + 5)}
    trees = {k: _numpy(v) for k, v in trees.items()}
    for name, mod in (("gen", jb.gen), ("gst", jb.gst), ("mpd", jb.mpd),
                      ("msd", jb.msd), ("mbd", jb.mbd),
                      ("stft", jb.stft_loss)):
        object.__setattr__(mod, "init", lambda *a, t=trees[name], **k: t)
    return trees


def gan_batch(cfg, seed=0, frames=5):
    from ttsx_torch.data.synthetic import synthetic_batch
    b = synthetic_batch(cfg, batch=2, frames=frames, seed=seed)
    rng = np.random.default_rng(seed + 100)
    b["pitch_pred"] = b["pitch"] + rng.normal(size=b["pitch"].shape).astype(
        np.float32)
    b["duration_pred"] = np.abs(rng.normal(size=b["duration"].shape)
                                ).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def block_init():
    """The reference block at the tiny config with the energy, pitch and
    duration terms on, its seeded trees and initial states (no compile),
    and a batch."""
    from ttsx.train.blocks import VocoderBlock as JVocoderBlock
    cfg = gan_cfg(lambda_energy=1.0)
    batch = gan_batch(cfg)
    jb = JVocoderBlock(jax_cfg(cfg))
    trees = vocoder_trees(jb, batch)
    return cfg, batch, trees, jb, jb.init_state(jax.random.PRNGKey(0), batch)


@pytest.fixture(scope="module")
def block_run(block_init):
    """One reference run of disc_step (R1 on) -> disc_step (R1 off) ->
    gen_step -> gen_step: each step's metrics, Adam first moments and
    draws, and the last states."""
    cfg, batch, trees, jb, st = block_init
    mp = pytest.MonkeyPatch()
    draws = JaxDraws(mp)
    steps = []
    try:
        for kind in ("disc", "disc", "gen", "gen"):
            fn = jb.disc_step if kind == "disc" else jb.gen_step
            (st, m), rec = draws.call(kind, fn, st, batch)
            parts = ("mpd", "msd", "mbd") if kind == "disc" else ("gen", "gst")
            steps.append(dict(kind=kind, metrics=m, draws=rec, mu={
                p: _numpy(mu_tree(getattr(st, p).opt_state)) for p in parts}))
    finally:
        mp.undo()
    return cfg, batch, trees, st, steps


def port_block(cfg, trees):
    from ttsx_torch.train.blocks import VocoderBlock
    pb = VocoderBlock(cfg, "cpu", 0)
    for name in ("gen", "gst", "mpd", "msd", "mbd"):
        load_flax(getattr(pb, name), trees[name])
    load_flax(pb.stft, trees["stft"])
    pb.states["gen"].reset_ema()
    return pb


def run_port(cfg, trees, steps, batch, dtype=torch.float32, gen_count=0):
    """The port's block, its generator's count set to ``gen_count``,
    through the reference run's steps on its draws; returns the block
    and, per step, its metrics and Adam first moments."""
    from ttsx_torch.train.blocks import match_lengths
    pb = port_block(cfg, trees)
    pb.states["gen"].step = gen_count
    if dtype != torch.float32:
        for m in (pb.gen, pb.gst, pb.mpd, pb.msd, pb.mbd, pb.stft):
            m.to(dtype)
        pb.states["gen"].reset_ema()
        pb._batch = lambda b: match_lengths(
            {k: torch.as_tensor(v).to(dtype) if v.dtype.kind == "f"
             else torch.as_tensor(v) for k, v in b.items()}, pb.hop)
    out = []
    for s in steps:
        pb.states["gen"].draws = ReplayDraws(s["draws"])
        got = (pb.disc_step if s["kind"] == "disc" else pb.gen_step)(batch)
        assert pb.states["gen"].draws.exhausted()
        mu = {}
        for part in s["mu"]:
            adamw = pb.states[part].tx.adamw
            mu[part] = {n: adamw.state[p]["exp_avg"].double()
                        for n, p in getattr(pb, part).named_parameters()}
        out.append((got, mu))
    return pb, out


@pytest.mark.slow    # the reference's two GAN steps compile in about 50 s
def test_vocoder_block_steps_match_reference(block_run):
    """disc_step with R1 (mpd's count 0) and without, then two gen_steps,
    the second with a non-zero adversarial term (its warmup is 1/160
    there): every metric; the discriminators' gradients after each of
    their updates (Adam's first moment) at the trainer tests' tolerance;
    the generator's and the GST's gradients held to a float64 run of the
    port's own steps no farther than twice the reference's f32 distance
    from it (+ 2e-8), and to the reference within 1 % of each
    parameter's largest moment; the generator's EMA after two updates;
    the frozen filterbank; the update counts.

    Why the generator's gradients take the float64 yardstick: at this
    size the gradient of its loss through the generator is f32-accurate
    only to about 1e-3 of its largest element (the L1 terms' signs flip on
    bins where fake and real agree to rounding; the log-magnitude term
    divides by magnitudes near its floor): the reference was 1.5e-3 to
    2.6e-3 from float64 at the first generator step, the port 0.8e-3 to
    1.5e-3, each other 2e-3 to 4e-3. The adversarial term's share of
    those gradients is too small for that check to see it;
    ``test_gen_step_adversarial_gradient_matches_reference`` holds it
    alone at the trainer tests' tolerance."""
    cfg, batch, trees, st, steps = block_run
    pb, runs = run_port(cfg, trees, steps, batch)
    _, runs64 = run_port(cfg, trees, steps, batch, torch.float64)
    for s, (got, mu), (_, mu64) in zip(steps, runs, runs64):
        close_metrics(got, s["metrics"])
        for part, ref_mu in s["mu"].items():
            module = getattr(pb, part)
            want = from_flax(module, {"params": ref_mu.get("params", ref_mu)})
            if s["kind"] == "disc":
                close_tree(mu[part], want, **MU_TOL)
                continue
            for n, ref in want.items():
                ref, port, f64 = ref.double(), mu[part][n], mu64[part][n]
                e_port = float((port - f64).abs().max())
                e_ref = float((ref - f64).abs().max())
                assert e_port <= 2 * e_ref + 2e-8, (part, n, e_port, e_ref)
                assert float((port - ref).abs().max()) <= (
                    1e-2 * float(ref.abs().max()) + 2e-8), (part, n)
    assert float(steps[0]["metrics"]["r1"]) > 0
    assert float(steps[1]["metrics"]["r1"]) == 0
    assert float(steps[2]["metrics"]["adv"]) == 0
    assert float(steps[3]["metrics"]["adv"]) != 0
    ema = from_flax(pb.gen, _numpy(st.gen.ema_params))
    for n, e in pb.states["gen"].ema.items():
        close(e, ema[n], dict(rtol=1e-6, atol=1e-6))
    fb0 = from_flax(pb.stft, trees["stft"])
    for k, v in pb.stft.state_dict().items():
        assert torch.equal(v, fb0[k]), k
    np.testing.assert_array_equal(
        jax.tree_util.tree_leaves(st.stft.params)[0],
        jax.tree_util.tree_leaves(trees["stft"])[0])
    for part in ("gen", "gst", "mpd", "msd", "mbd"):
        assert pb.states[part].step == int(getattr(st, part).step) == 2


@pytest.fixture(scope="module")
def adv_run():
    """The reference's gen_step with the adversarial term alone
    (``lambda_fm`` and ``lambda_stft`` 0, no energy, pitch or duration
    term) at the generator's count 10 * ``r1_interval``, where the warmup
    is 1: the config, batch, trees, that count and the step's metrics,
    Adam first moments and draws."""
    from ttsx.train.blocks import VocoderBlock as JVocoderBlock
    cfg = gan_cfg(lambda_fm=0.0, lambda_stft=0.0)
    batch = {k: v for k, v in gan_batch(cfg, seed=1).items()
             if not k.endswith("_pred")}
    jb = JVocoderBlock(jax_cfg(cfg))
    trees = vocoder_trees(jb, batch, seed=10)
    st = jb.init_state(jax.random.PRNGKey(0), batch)
    count = 10 * cfg.vocoder.r1_interval
    st = st.replace(gen=st.gen.replace(
        step=jnp.asarray(count, st.gen.step.dtype)))
    mp = pytest.MonkeyPatch()
    try:
        (st, m), rec = JaxDraws(mp).call("gen", jb.gen_step, st, batch)
    finally:
        mp.undo()
    step = dict(kind="gen", metrics=m, draws=rec, mu={
        p: _numpy(mu_tree(getattr(st, p).opt_state)) for p in ("gen", "gst")})
    return cfg, batch, trees, count, step


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gen_step_adversarial_gradient_matches_reference(adv_run, remat,
                                                         monkeypatch):
    """The adversarial term at full warmup, through the discriminators,
    the generator and the GST: the metrics at 1e-5, and every generator
    and GST gradient (Adam's first moment) at the trainer tests' 1e-4 +
    2e-8. The hinge generator loss is linear in the logits, so this
    gradient is f32-accurate where the full loss's is not. With
    ``remat`` each FiLM residual block is checkpointed and recomputed in
    the backward pass, with the same result."""
    import ttsx_torch.models.vocoder as pv
    cfg, batch, trees, count, step = adv_run
    calls, checkpoint = [], pv.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn)
        return checkpoint(fn, *args, **kw)

    monkeypatch.setattr(pv, "checkpoint", counted)
    pcfg = dataclasses.replace(cfg, vocoder=dataclasses.replace(
        cfg.vocoder, remat=remat))
    pb, [(got, mu)] = run_port(pcfg, trees, [step], batch, gen_count=count)
    close_metrics(got, step["metrics"])
    assert float(got["adv"]) != 0 and float(got["stft"]) == 0
    assert set(got) == {"g_loss", "adv", "fm", "stft"}
    for part, ref_mu in step["mu"].items():
        module = getattr(pb, part)
        want = from_flax(module, {"params": ref_mu.get("params", ref_mu)})
        assert all(float(v.abs().max()) > 0 for v in want.values()), part
        close_tree(mu[part], want, **MU_TOL)
    n_blocks = len(cfg.vocoder.upsample_factors) * len(
        cfg.vocoder.res_dilations)
    assert len(calls) == (n_blocks if remat else 0)
    assert pb.states["gen"].step == count + 1


# ------------------------------------------------------------ the port's rules
def test_length_rule_on_a_collated_batch():
    """A collated bucket of N samples has N // hop + 1 frames; both steps
    cut every frame-axis entry to N // hop frames and the wav to whole
    hops, and a matching batch passes unchanged."""
    from ttsx_torch.train.blocks import VocoderBlock, match_lengths
    cfg = gan_cfg()
    hop = 256
    b = gan_batch(cfg, frames=9)
    n = 8 * hop + 100
    b["wav"] = randn(3, 2, n, 1, scale=0.1)
    cut = match_lengths({k: torch.as_tensor(v) for k, v in b.items()}, hop)
    for k in ("mel", "prosody", "text_emb", "pitch", "pitch_pred",
              "frame_mask"):
        assert cut[k].shape[1] == n // hop == 8, k
    assert cut["wav"].shape[1] == 8 * hop
    assert cut["speaker"].shape == b["speaker"].shape
    same = match_lengths(cut, hop)
    assert all(same[k] is cut[k] or torch.equal(same[k], cut[k]) for k in cut)
    pb = VocoderBlock(cfg, "cpu", 0)
    d, g = pb.disc_step(b), pb.gen_step(b)
    assert np.isfinite(float(d["d_total"])) and np.isfinite(float(g["g_loss"]))


def _trainer(cfg, batches, **kw):
    from ttsx_torch.train.engine import UnifiedTrainer
    return UnifiedTrainer(cfg, iter(batches), device="cpu", **kw)


@pytest.mark.parametrize("d_ema,g_ema,at_1,at_3", [
    (3.0, 1.0, 2, 3), (1.6, 1.0, 2, 3), (1.5, 1.0, 1, 3), (1.0, 1.0, 1, 3),
    (0.5, 1.0, 1, 3), (0.1, 1.0, 1, 2), (1.0, 0.0, 2, 3)])
def test_dynamic_d_steps(d_ema, g_ema, at_1, at_3):
    """The D:G ratio above 1.5 adds a step (at most 3), below 0.5 takes
    one away (at least 1), else ``gan_d_steps`` (1 and 3 here); with
    ``dynamic_gan`` off, ``gan_d_steps``."""
    tr = _trainer(gan_cfg(), [], blocks=())
    tr.state.d_loss_ema, tr.state.g_loss_ema = d_ema, g_ema
    assert tr._dynamic_d_steps() == at_1
    tr.cfg = dataclasses.replace(tr.cfg, train=dataclasses.replace(
        tr.cfg.train, gan_d_steps=3))
    assert tr._dynamic_d_steps() == at_3
    tr.cfg = dataclasses.replace(tr.cfg, train=dataclasses.replace(
        tr.cfg.train, gan_d_steps=2, novel=dataclasses.replace(
            tr.cfg.train.novel, dynamic_gan=False)))
    assert tr._dynamic_d_steps() == 2


def test_engine_trains_the_vocoder_after_freeze_and_counts_steps():
    """``vocoder_freeze_until`` = 1: step 0 leaves the vocoder alone, step
    1 runs the ratio's discriminator steps and one generator step, and
    the loss EMAs move with a = 0.9; a batch without "wav" skips it."""
    cfg = gan_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, vocoder_freeze_until=1))
    batches = [gan_batch(cfg, seed=s) for s in range(3)]
    tr = _trainer(cfg, batches, blocks=("vocoder",), val_iter=batches[:1])
    voc = tr.blocks["vocoder"].states
    m0 = tr.train_step(batches[0])
    assert "vocoder/g_loss" not in m0 and voc["gen"].step == 0
    tr.state.d_loss_ema = 2.0           # ratio 2: two discriminator steps
    m1 = tr.train_step(batches[1])
    assert m1["vocoder/d_steps"] == 2
    assert voc["mpd"].step == voc["mbd"].step == 2 and voc["gen"].step == 1
    assert tr.state.d_loss_ema == pytest.approx(
        0.9 * 2.0 + 0.1 * m1["vocoder/d_loss"])
    assert tr.state.g_loss_ema == pytest.approx(
        0.9 + 0.1 * m1["vocoder/g_loss"])
    nowav = {k: v for k, v in batches[2].items() if k != "wav"}
    assert "vocoder/g_loss" not in tr.train_step(nowav)
    assert tr.validate() == {}          # the vocoder alone: no validation


def test_engine_skips_an_oom_gan_step_and_keeps_the_d_updates(monkeypatch):
    """An out-of-memory error in gen_step skips the rest of the GAN step
    and counts it; the discriminator updates made before it stay (the
    port's stated departure). Any other error propagates."""
    cfg = gan_cfg()
    batches = [gan_batch(cfg, seed=s) for s in range(3)]
    tr = _trainer(cfg, batches, blocks=("vocoder",))
    voc = tr.blocks["vocoder"]

    def oom(batch):
        raise torch.OutOfMemoryError("out of memory on the card")

    monkeypatch.setattr(voc, "gen_step", oom)
    m = tr.train_step(batches[0])
    assert m["vocoder/oom"] == 1 == tr.state.oom_count
    assert voc.states["mpd"].step == 1 and voc.states["gen"].step == 0
    assert all(p.grad is None for p in voc.gen.parameters())
    assert tr.state.d_loss_ema == 1.0

    def other(batch):
        raise RuntimeError("a shape mismatch")

    monkeypatch.setattr(voc, "gen_step", other)
    with pytest.raises(RuntimeError, match="shape mismatch"):
        tr.train_step(batches[1])
    assert tr.state.oom_count == 1


# ------------------------------------------------------------------ slim export
def test_port_export_loads_in_the_reference_and_synthesizes_the_same(
        tmp_path, block_init):
    """A port export (EMA generator, GST, meta) loads through
    ``ttsx.train.slim_export.load_vocoder_slim`` into a reference state,
    and the reference's generator then synthesizes what the port's does
    from the same file."""
    from ttsx.train.slim_export import load_slim_meta, load_vocoder_slim as jl
    from ttsx_torch.train.blocks import VocoderBlock
    from ttsx_torch.train.slim_export import (load_vocoder_slim,
                                              save_vocoder_slim)
    cfg, batch, trees, _, st = block_init
    pb = port_block(cfg, trees)
    pb.gen_step(batch)                 # the EMA now differs from the params
    path = str(tmp_path / "voc.npz")
    save_vocoder_slim(path, pb, meta={"steps": 1})
    assert int(load_slim_meta(path)["steps"]) == 1
    jst = jl(path, st)
    fresh = VocoderBlock(cfg, "cpu", 1)
    assert int(load_vocoder_slim(path, fresh)["steps"]) == 1
    for n, e in pb.states["gen"].ema.items():   # float16 storage
        close(dict(fresh.gen.named_parameters())[n], e,
              dict(rtol=1e-3, atol=1e-3))
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    style = randn(9, 2, cfg.vocoder.style_dim)
    with torch.no_grad():
        got = fresh.gen(b["mel"], b["prosody"], torch.as_tensor(style),
                        b["emotion_probs"])
        gst = fresh.gst(b["mel"])
    ref = jax.jit(lambda p, *a: jst.gen.apply_fn(p, *a))(
        jst.gen.ema_params, batch["mel"], batch["prosody"], style,
        batch["emotion_probs"])
    close(got, ref)
    close(gst, jst.gst.apply_fn(jst.gst.params, batch["mel"]))
    close_tree(dict(fresh.gen.named_parameters()),
               from_flax(fresh.gen, _numpy(jst.gen.params)), 0, 0)


def test_reference_export_and_the_zoo_load_in_the_port(tmp_path, block_init):
    """A reference export loads into a port block (parameters equal to the
    reference's after its float16 round trip, EMA reset to them, the
    discriminators untouched); the zoo's vocoder.npz warm-starts a block at
    the zoo's config; a file without the GST raises."""
    from ttsx.train.slim_export import save_vocoder_slim as jsave
    from ttsx_torch.core.config import zoo_cfg
    from ttsx_torch.train.blocks import VocoderBlock
    from ttsx_torch.train.slim_export import load_vocoder_slim
    from ttsx_torch.weights import WeightMismatch, load_slim_npz
    from ttsx_torch.zoo import DEFAULT_ZOO
    cfg, _, trees, _, st = block_init
    path = str(tmp_path / "ref.npz")
    jsave(path, st, meta={"steps": 4})
    pb = VocoderBlock(cfg, "cpu", 2)
    mpd0 = {k: v.clone() for k, v in pb.mpd.state_dict().items()}
    assert int(load_vocoder_slim(path, pb)["steps"]) == 4
    file = load_slim_npz(path)
    for name, module in (("gen_ema", pb.gen), ("gst", pb.gst)):
        close_tree(module.state_dict(), from_flax(module, file[name]), 0, 0)
    close_tree(pb.states["gen"].ema, pb.gen.state_dict(), 0, 0)
    close_tree(pb.mpd.state_dict(), mpd0, 0, 0)
    zoo = VocoderBlock(zoo_cfg(False), "cpu", 0)
    load_vocoder_slim(str(DEFAULT_ZOO / "vocoder.npz"), zoo)
    zfile = load_slim_npz(str(DEFAULT_ZOO / "vocoder.npz"))["gen_ema"]
    close_tree(zoo.gen.state_dict(), from_flax(zoo.gen, zfile), 0, 0)
    np.savez(str(tmp_path / "bad.npz"), **{
        k: v for k, v in np.load(path).items() if not k.startswith("gst|")})
    with pytest.raises(WeightMismatch, match="gst"):
        load_vocoder_slim(str(tmp_path / "bad.npz"), pb)


@pytest.mark.parametrize("name", ["acoustic", "refiner", "gen", "gst", "mpd",
                                  "msd", "mbd"])
def test_to_flax_gives_back_the_reference_tree(name, block_init):
    """``weights.to_flax`` of a module filled from a reference tree is that
    tree: the same keys (``params`` and ``vq_stats``), shapes and values,
    for every leaf layer of the chain (attention heads, norms, embeddings,
    convs, transposed convs, spectral-normed convs)."""
    from torch_train_helpers import _init_tree, batch_of, tiny_cfg
    from ttsx.train import blocks as jblocks
    from ttsx_torch.train.engine import BlockRegistry
    from ttsx_torch.weights import to_flax
    if name in ("acoustic", "refiner"):
        cfg = tiny_cfg()
        jcls = {"acoustic": jblocks.AcousticBlock,
                "refiner": jblocks.RefinerBlock}[name]
        tree = _numpy(_init_tree(name, jcls(jax_cfg(cfg)), batch_of(cfg), 0))
        module = BlockRegistry.create(name, cfg, "cpu", 0).model
    else:
        cfg, _, trees, _, _ = block_init
        tree = trees[name]
        module = getattr(port_block(cfg, trees), name)
    load_flax(module, tree)
    got = to_flax(module)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    got, want = flat(got), flat(tree)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
