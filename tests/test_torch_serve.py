"""bf16 serving, the voice transform and streaming synthesis against ``ttsx``.

At tests/test_serve.py's tiny config with both vocoder kernel flags on
(the reference runs its Pallas kernels in interpret mode, the port their
plain versions), on one set of seeded weights in which every layer
carries signal (``init_like``).

The reference's bf16 server casts its parameters and float inputs to
bfloat16 and lets JAX promote; its stage outputs are float32. XLA on the
CPU, when allowed excess precision (its default), skips some bf16
roundings inside fused ops, so the jitted reference departs from its own
op-by-op graph (measured: 4.9e-6 at mel0, the same order at the
waveform). The port rounds every op, so it is held (1) op by op against
the reference compiled with ``xla_allow_excess_precision=False``
(measured: mel0 7.5e-9, mel_ref 3.4e-6 at a peak of 1.65, wav 7.5e-9;
stated: mels 1e-4, wav 1e-6), and (2) against the reference's own bf16
server as it runs by default: its waveforms within 2.5e-5 (measured
5.4e-6, against a bf16-to-f32 distance of 6.2e-5 at a peak of 1.7e-2),
and no farther from the reference's f32 waveform than 1.5 times the
reference's bf16 waveform is, plus 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import close, init_like, port, randn, t
from torch_train_helpers import jax_cfg

from ttsx_torch.core import config as tc

B, T = 2, 12
LENS = (12, 9)
OP_MEL_TOL, OP_WAV_TOL = 1e-4, 1e-6
SERVER_WAV_TOL = 2.5e-5
F32_WAV_TOL = 1e-5     # the f32 routes: measured 7.5e-9
NO_EXCESS = {"xla_allow_excess_precision": False}


def _cfg() -> tc.TTSXConfig:
    s4 = tc.S4Config(heads=2, norm_groups=2, causal=True, dropout=0.0)
    return tc.TTSXConfig(
        acoustic=tc.AcousticConfig(text_emb_dim=16, hidden_channels=16,
                                   conformer_layers=1, transformer_dim=32,
                                   num_layers=1, attention_heads=2,
                                   speaker_dim=8),
        refiner=tc.RefinerConfig(levels=1, cond_dim=16, hidden_channels=16,
                                 hsf_hidden=8, style_dim=8, beta_hidden=8,
                                 s4=s4, sde_steps=2),
        vocoder=tc.VocoderConfig(hidden_dim=16, cond_dim=8, style_dim=16,
                                 disc_ch_growth=2, use_pallas_upsample=True,
                                 use_pallas_resblock_stack=True))


def _compiled(fn, *args):
    """``fn`` jitted and compiled with every op rounded to its dtype."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(*args)


@pytest.fixture(scope="module")
def tiny():
    """The reference's servers and the port's on one set of weights."""
    from ttsx.models.pipeline import TTSPipeline as JPipeline
    from ttsx.serve import SynthesisRequest as JRequest
    from ttsx.serve import SynthesisServer as JServer
    from ttsx_torch.models.pipeline import TTSPipeline
    from ttsx_torch.serve import SynthesisRequest, SynthesisServer
    cfg = _cfg()
    jc = jax_cfg(cfg)
    jp = JPipeline(jc)
    x = dict(text=randn(0, B, T, 16), pros=randn(1, B, T, 18),
             emo=np.random.default_rng(5).dirichlet(np.ones(6), B)
             .astype(np.float32),
             spk=randn(2, B, 8), sid=np.array([0, 2], np.int32))
    mel, style = randn(3, B, T, 80), randn(4, B, 16)
    params = {
        "acoustic": init_like(jp.acoustic, x["text"], x["pros"], x["emo"],
                              speaker=x["spk"], seed=1),
        "refiner": init_like(jp.refiner, mel, x["pros"], x["sid"],
                             x["text"], seed=2),
        "gst": init_like(jp.gst, mel, seed=3),
        "generator": init_like(jp.generator, mel, x["pros"], style,
                               x["emo"], seed=4)}
    pipe = TTSPipeline(cfg)
    for k in params:
        port(getattr(pipe, k), params[k])
    reqs = [(x["text"][i, :n], x["pros"][i, :n], x["emo"][i], x["spk"][i],
             int(x["sid"][i])) for i, n in enumerate(LENS)]
    kw = dict(max_batch=B, frames=T)
    j = {bf: JServer(jc, params, bf16=bf, **kw) for bf in (True, False)}
    p = {bf: SynthesisServer(pipe, device="cpu", bf16=bf, **kw)
         for bf in (True, False)}
    out = dict(cfg=cfg, jc=jc, jp=jp, params=params, pipe=pipe, x=x,
               jserver=j, pserver=p,
               jwav={bf: j[bf].serve_batch([JRequest(*r) for r in reqs])
                     for bf in j},
               pwav={bf: p[bf].serve_batch([SynthesisRequest(*r)
                                            for r in reqs]) for bf in p})
    # the stages of both bf16 servers on the padded bucket
    srv = j[True]
    *arrays, _ = srv._pad_batch([JRequest(*r) for r in reqs])
    text, pros, emo, spk = (jnp.asarray(a, jnp.bfloat16) for a in arrays[:4])
    sid = jnp.asarray(arrays[4])
    sp = srv.params
    mel0 = _compiled(srv._ac_fn, sp["acoustic"], text, pros, emo, spk)
    mel_ref = _compiled(srv._rf_fn, sp["refiner"], mel0, pros, sid, text)
    wav = _compiled(srv._gg_fn, sp["gst"], sp["generator"], mel_ref, pros,
                    emo)
    out["jstages"] = (mel0, mel_ref, wav)
    out["jstages_default"] = [fn(*a).dtype for fn, a in (
        (srv._ac_fn, (sp["acoustic"], text, pros, emo, spk)),
        (srv._rf_fn, (sp["refiner"], mel0, pros, sid, text)),
        (srv._gg_fn, (sp["gst"], sp["generator"], mel_ref, pros, emo)))]
    out["pstages"] = p[True].stages(*(torch.as_tensor(a) for a in arrays))
    # one reference streamer (one compiled chunk) for both streaming tests
    from ttsx.streaming import StreamingSynthesizer as JStream
    out["jstream"] = JStream(jc, params, chunk_frames=8, overlap_frames=2)
    return out


def test_bf16_is_the_default_as_in_the_reference():
    import inspect
    from ttsx.serve import SynthesisServer as JServer
    from ttsx_torch.serve import SynthesisServer
    from ttsx_torch.zoo import serve_from_zoo
    want = inspect.signature(JServer).parameters["bf16"].default
    assert want is True
    assert inspect.signature(SynthesisServer).parameters["bf16"].default \
        is want
    srv = serve_from_zoo(device="cpu", max_batch=1, frames=4)
    assert srv.dtype == torch.bfloat16
    assert srv.pipe.refiner.Dense_0.weight.dtype == torch.bfloat16


def test_bf16_stage_dtypes_match_reference(tiny):
    """mel0, mel_ref and the waveform of the bf16 server: float32 in both
    packages (the graph promotes back at its first float32 operand)."""
    mel0, mel_ref, wav = tiny["jstages"]
    got = tiny["pstages"]
    want = [str(a.dtype) for a in (mel0, mel_ref, wav)]
    assert [str(a) for a in tiny["jstages_default"]] == want
    assert [str(a.dtype).replace("torch.", "")
            for a in (got.mel0, got.mel_ref, got.wav)] == want
    assert want == ["float32"] * 3
    assert all(w.dtype == np.float32 for w in tiny["pwav"][True])


def test_bf16_server_matches_reference_op_by_op(tiny):
    mel0, mel_ref, wav = tiny["jstages"]
    got = tiny["pstages"]
    close(got.mel0, mel0, 0, OP_MEL_TOL)
    close(got.mel_ref, mel_ref, 0, OP_MEL_TOL)
    close(got.wav, wav, 0, OP_WAV_TOL)
    assert float(np.abs(np.asarray(wav)).max()) > 1e-3


def test_bf16_server_matches_reference_server(tiny):
    """Against the reference's bf16 server as it runs: within the stated
    tolerance, and no farther from its f32 waveforms than its own bf16
    waveforms are (times 1.5, plus 1e-6)."""
    jbf, jf = tiny["jwav"][True], tiny["jwav"][False]
    pbf, pf = tiny["pwav"][True], tiny["pwav"][False]
    for i, n in enumerate(LENS):
        assert pbf[i].shape == jbf[i].shape == (n * 256,)
        np.testing.assert_allclose(pbf[i], jbf[i], rtol=0,
                                   atol=SERVER_WAV_TOL)
        np.testing.assert_allclose(pf[i], jf[i], rtol=0, atol=F32_WAV_TOL)
        ref_dist = float(np.abs(jbf[i] - jf[i]).max())
        assert ref_dist > 1e-6          # bf16 serving moved the output
        assert float(np.abs(pbf[i] - jf[i]).max()) <= 1.5 * ref_dist + 1e-6


def test_bf16_cast_covers_parameters_and_vq_stats_only(tiny):
    """The server casts every float32 parameter and the VQ statistics
    (the float32 leaves of the reference's trees, one state-dict entry
    each) and leaves the float32 constants and the caller's pipeline."""
    jtree = tiny["jserver"][True].params
    n_ref = sum(a.dtype == jnp.bfloat16
                for a in jax.tree_util.tree_leaves(jtree))
    pipe = tiny["pserver"][True].pipe
    state = {f"{k}.{n}": v for k in ("acoustic", "refiner", "gst",
                                     "generator")
             for n, v in getattr(pipe, k).state_dict().items()}
    assert {v.dtype for v in state.values()} == {torch.bfloat16}
    assert len(state) == n_ref
    assert any("embed_sum" in k for k in state)
    assert any("cluster_size" in k for k in state)
    consts = {n: b for n, b in pipe.named_buffers() if n not in state}
    assert any(n.endswith("a_diag") for n in consts)
    assert "refiner.pe" in consts
    assert {b.dtype for b in consts.values()} == {torch.float32}
    assert {p.dtype for p in tiny["pipe"].parameters()} == {torch.float32}


def _k1(seed, dt_x, dt_w):
    x = randn(seed, 2, 5, 8)
    w, b = randn(seed + 1, 4, 8, 8, scale=0.3), randn(seed + 2, 8)
    return (t(x).to(dt_x), t(w).to(dt_w), t(b).to(dt_w)), 2


def _k2(seed, dt_x, dt_w):
    n, C = 3, 8
    args = [t(randn(seed, 2, 40, C)).to(dt_x),
            t(randn(seed + 1, 2, 10, 2 * n * C, scale=0.3)).to(dt_x)]
    args += [t(randn(seed + 2 + i, *s, scale=0.2)).to(dt_w) for i, s in
             enumerate(((n, 3, C, 2 * C), (n, 2 * C), (n, 3, C, C), (n, C)))]
    return args, (1, 3, 5)


def _k5(seed, dt_x, dt_w):
    C = 8
    args = [t(randn(seed + i, 2, 30, C, scale=0.3 if i else 1.0)).to(dt_x)
            for i in range(3)]
    args += [t(randn(seed + 3 + i, *s, scale=0.2)).to(dt_w) for i, s in
             enumerate(((3, C, 2 * C), (2 * C,), (3, C, C), (C,)))]
    return args, 3


@pytest.mark.parametrize("kernel", ["upsample", "resblock_stack",
                                    "resblock"])
@pytest.mark.parametrize("which", ["weights", "x"])
def test_kernel_plain_versions_take_bf16(kernel, which):
    """The wrappers' plain versions (what a CPU tensor runs) on bf16
    weights, or a bf16 x (and FiLM): the float32 computation on the
    bf16-rounded values, returned in x's dtype, as the reference kernel
    casts; and the reference kernel itself within K1/K2/K5's tolerance
    (a bf16 output within one bf16 step)."""
    from ttsx.ops.resblock_kernel import film_resblock_pallas
    from ttsx.ops.resblock_stack_kernel import film_resblock_stack_pallas
    from ttsx.ops.upsample_kernel import upsample_lrelu_pallas
    from ttsx_torch import ops
    bf, f32 = torch.bfloat16, torch.float32
    dt_x, dt_w = (f32, bf) if which == "weights" else (bf, f32)
    make, fn, ref_fn, tol = {
        "upsample": (_k1, ops.convt_upsample, lambda *a: upsample_lrelu_pallas(
            *a, interpret=True, lrelu=False), 1e-5),
        "resblock_stack": (_k2, ops.film_resblock_stack,
                           lambda *a: film_resblock_stack_pallas(
                               *a, interpret=True), 1e-4),
        "resblock": (_k5, ops.film_resblock,
                     lambda *a: film_resblock_pallas(*a, interpret=True),
                     1e-5)}[kernel]
    args, extra = make(70, dt_x, dt_w)
    got = fn(*args, extra)
    want = fn(*(a.float() for a in args), extra).to(dt_x)
    assert got.dtype == dt_x
    assert torch.equal(got, want)
    ref = ref_fn(*(jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if a.dtype == bf else jnp.float32) for a in args), extra)
    assert str(ref.dtype) == str(dt_x).replace("torch.", "")
    # a bf16 output may round the other way: one bf16 step, 2**-7
    # relative at most
    close(got.float(), ref.astype(jnp.float32),
          2.0 ** -7 if dt_x == bf else tol, tol)


@pytest.mark.parametrize("bf16", [False, True])
def test_voice_transform_matches_reference(tiny, bf16):
    """``make_voice_transform`` on the f32 pipeline and on the bf16
    server's, against the reference's on the matching tree (bf16: the
    reference compiled op by op, as above)."""
    from ttsx.serve import make_voice_transform as jmake
    from ttsx_torch.serve import make_voice_transform
    x, cfg = tiny["x"], tiny["cfg"]
    mel_src, ref_mel = randn(7, B, T, 80), randn(8, B, 10, 80)
    sid = np.array([1, 0], np.int32)
    pdt = jnp.bfloat16 if bf16 else jnp.float32
    pros = jnp.asarray(x["pros"], pdt)
    jfn = jmake(tiny["jc"], tiny["jp"])
    jparams = tiny["jserver"][bf16].params
    ref = _compiled(jfn, jparams, jnp.asarray(mel_src), pros, sid,
                    jnp.asarray(ref_mel))
    fn = make_voice_transform(tiny["pserver"][bf16].pipe)
    got = fn(t(mel_src), t(x["pros"]).to(torch.bfloat16 if bf16
                                         else torch.float32),
             t(sid).long(), t(ref_mel))
    assert got.shape == (B, T * cfg.vocoder.hop_length, 1)
    assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
    assert float(np.abs(np.asarray(ref)).max()) > 1e-3
    close(got, ref, 0, OP_WAV_TOL if bf16 else F32_WAV_TOL)


def test_streaming_matches_reference(tiny):
    """20 frames in chunks of 8 with overlap 2 (3 chunks): the chunk
    bounds, and the cross-faded waveform against the reference's
    streamer on the same weights."""
    from ttsx_torch.streaming import StreamingSynthesizer
    n = 20
    text, pros = randn(9, 1, n, 16), randn(10, 1, n, 18)
    emo = np.full((1, 6), 1 / 6, np.float32)
    spk, sid = randn(11, 1, 8), np.array([1], np.int32)
    ss = StreamingSynthesizer(tiny["pipe"], chunk_frames=8, overlap_frames=2,
                              device="cpu")
    assert ss.chunks(n) == [(0, 8), (6, 14), (12, 20)]
    got = ss.synthesize(text, pros, emo, spk, sid)
    ref = tiny["jstream"].synthesize(text, pros, emo, spk, sid)
    assert got.shape == ref.shape == (1, n * ss.hop)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_WAV_TOL)
    assert float(np.abs(ref).max()) > 1e-3


def test_streaming_one_chunk_is_the_direct_call(tiny):
    """An input of one chunk's length: the streamer's output is the
    pipeline's ``synthesize`` output, and the reference's."""
    from ttsx_torch.streaming import StreamingSynthesizer
    text, pros = randn(12, 1, 8, 16), randn(13, 1, 8, 18)
    emo = np.full((1, 6), 1 / 6, np.float32)
    spk, sid = randn(14, 1, 8), np.array([2], np.int32)
    ss = StreamingSynthesizer(tiny["pipe"], chunk_frames=8, overlap_frames=2,
                              device="cpu")
    assert ss.chunks(8) == [(0, 8)]
    got = ss.synthesize(text, pros, emo, spk, sid)
    direct = tiny["pipe"].synthesize(t(text), t(pros), t(emo), t(spk),
                                     t(sid).long()).wav[:, :, 0].numpy()
    np.testing.assert_array_equal(got, direct)
    ref = tiny["jstream"].synthesize(text, pros, emo, spk, sid)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_WAV_TOL)

