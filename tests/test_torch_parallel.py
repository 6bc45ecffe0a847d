"""The port's mesh, data parallelism and band tensor parallelism
(``ttsx_torch.core.mesh``, ``ttsx_torch.parallel``) on two gloo ranks
against ``ttsx`` on one device.

One group of two rank processes (tests/torch_parallel_helpers.py, which
import no JAX) runs every case; the module's fixture writes their inputs
(the reference's weights, batches and recorded draws, as in
torch_train_helpers.py), starts the ranks, and computes the references
while they run. Each rank keeps its rows of the global batch, so both
ranks' results are held to the reference's single-device run:

* the acoustic step with unequal frame masks on the two ranks, and the
  refiner step with three VQ codes forced dead (restarted from rows of
  either rank; dropout off and one band: the reference's trace and
  compile of the step are most of this file's time, and what a rank
  does differently depends on neither), at tests/test_sharding.py's 2e-5 on the states, the
  gradients (Adam's first moment after the lr-0 update) at
  torch_train_helpers.py's tolerances, and the SDE sample at 2e-4;
* the band_tp generator at dp = 1 x tp = 2 at 2e-5;
* the f32 server at dp = 2 within tests/test_torch_serve.py's
  ``F32_WAV_TOL``;

and against the port without a mesh (in the rank processes, after the
mesh run, or here): a GAN step at tp = 2 and two engine steps at dp = 2
within 1e-5, the SDE sample on the port's own draws, and the dryrun's
own check against one rank.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_helpers import Group
from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_parity_helpers import init_like, randn
from torch_train_helpers import (JaxDraws, batch_of, close_metrics, gan_cfg,
                                 jax_cfg, seed_block_init, tiny_cfg)

from ttsx_torch.core import config as tc
from ttsx_torch.weights import from_flax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HERE = Path(__file__).resolve().parent
STATE_TOL = 2e-5        # tests/test_sharding.py's params tolerance
SDE_TOL = 2e-4          # tests/test_sharding.py's SDE tolerance
F32_WAV_TOL = 1e-5      # tests/test_torch_serve.py's f32 server tolerance
PORT_TOL = 1e-5         # the port at dp = 2 or tp = 2 against one process
GRAD_SCALE_TOL = 1e-5   # gradients: 1e-4 relative + 1e-5 of the tensor's max
B, T = 4, 8
DEAD = (1, 2, 5)        # VQ codes forced dead: restart rows 15, 30, 11 of 32
CASES = ("mesh", "shard", "band_tp", "gan_band_tp", "server", "engine",
         "oom", "dryrun")
LATE_CASES = ("acoustic", "refiner")    # their inputs need the reference
# tests/test_sharding.py's generator config
SHARDING_VOCODER = tc.VocoderConfig(hidden_dim=16, cond_dim=8, style_dim=16,
                                    disc_ch_growth=2, disc_periods=(2, 3),
                                    disc_kernel_sizes=(15,),
                                    stft_sizes=(512,))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _masked_batch(cfg):
    """4 rows: rank 0's two with every frame, rank 1's with 3 and 5."""
    batch = batch_of(cfg, batch=B, frames=T)
    mask = np.ones((B, T), bool)
    mask[2, 3:] = mask[3, 5:] = False
    batch["frame_mask"] = mask
    return batch


def _acoustic_inputs(mp, cfg, batch):
    from ttsx.train.blocks import AcousticBlock as J
    jb = J(jax_cfg(cfg))
    tree = seed_block_init("acoustic", jb, batch, 0)
    st = jb.init_state(jax.random.PRNGKey(0), batch)
    draws = JaxDraws(mp)
    (st1, out), rec = draws.call("a", jb.train_step, st, batch)
    return ({"cfg": tc.to_dict(cfg), "tree": tree, "batch": batch,
             "records": rec}, _step_ref(cfg, tree, st1, out))


def _step_ref(cfg, tree, state, out):
    """A reference step's result as numpy: the new variables, Adam's
    first moment, the metrics and the prediction."""
    chain = getattr(state.opt_state, "inner_state", state.opt_state)
    return {"cfg": tc.to_dict(cfg), "tree": tree,
            "params": _numpy(state.params), "mu": _numpy(chain[1][0].mu),
            "metrics": {k: float(v) for k, v in out["metrics"].items()},
            "mel_pred": np.asarray(out.get("mel_pred", np.zeros(0)))}


def _refiner_inputs(mp, cfg, batch):
    from ttsx.models.refiner import sde_sample
    from ttsx.train.blocks import RefinerBlock as J
    jb = J(jax_cfg(cfg))
    tree = seed_block_init("refiner", jb, batch, 1)
    cs = tree["vq_stats"]["vq"]["stage_0"]["cluster_size"]
    cs[list(DEAD)] = 0.05               # below dead_thresh after one decay
    st = jb.init_state(jax.random.PRNGKey(1), batch)
    mel_pred = batch["mel"] + 0.1 * randn(3, *batch["mel"].shape)
    draws = JaxDraws(mp)
    (st1, out), rec = draws.call(
        "r", jb.train_step, st, batch, jnp.asarray(mel_pred),
        jnp.asarray(0.5, jnp.float32), jnp.asarray(0.7, jnp.float32))
    mp.undo()
    key = jax.random.PRNGKey(7)
    steps = cfg.refiner.sde_steps
    noise = [np.asarray(jax.random.normal(k, mel_pred.shape))
             for k in jax.random.split(key, steps)]
    sde = jax.jit(lambda p, *a: sde_sample(jb.model, p, *a, key))(
        st1.params, *(jnp.asarray(a) for a in (
            mel_pred, batch["prosody"], batch["style_id"],
            batch["text_emb"])))
    return ({"cfg": tc.to_dict(cfg), "tree": tree, "batch": batch,
             "records": rec, "mel_pred": mel_pred, "noise": noise},
            {**_step_ref(cfg, tree, st1, out), "sde": np.asarray(sde),
             "mel_pred": mel_pred, "batch": batch})


def refiner_reference(out_path):
    """The reference's refiner step and SDE sample, and the ranks' inputs
    for them, saved to ``out_path``: run by the fixture in a process of
    its own (its trace and compile are most of this file's time), beside
    the acoustic reference and the ranks."""
    jax.config.update("jax_platforms", "cpu")
    cfg = tiny_cfg(dropout=0.0)
    cfg = dataclasses.replace(cfg, refiner=dataclasses.replace(
        cfg.refiner, bands=(80,)))
    with pytest.MonkeyPatch.context() as mp:
        inputs, ref = _refiner_inputs(mp, cfg, _masked_batch(cfg))
    torch.save({"inputs": inputs, "ref": ref}, out_path)


def _server_cfg():
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
                                 disc_ch_growth=2))


def _server_inputs():
    from ttsx.models.pipeline import TTSPipeline as JPipeline
    cfg = _server_cfg()
    jp = JPipeline(jax_cfg(cfg))
    Tq = 12
    x = dict(text=randn(20, B, Tq, 16), pros=randn(21, B, Tq, 18),
             emo=np.random.default_rng(22).dirichlet(np.ones(6), B)
             .astype(np.float32), spk=randn(23, B, 8),
             sid=np.array([0, 2, 1, 3], np.int32))
    mel, style = randn(24, B, Tq, 80), randn(25, B, 16)
    params = {
        "acoustic": init_like(jp.acoustic, x["text"], x["pros"], x["emo"],
                              speaker=x["spk"], seed=1),
        "refiner": init_like(jp.refiner, mel, x["pros"], x["sid"],
                             x["text"], seed=2),
        "gst": init_like(jp.gst, mel, seed=3),
        "generator": init_like(jp.generator, mel, x["pros"], style,
                               x["emo"], seed=4)}
    reqs = [(x["text"][i, :n], x["pros"][i, :n], x["emo"][i], x["spk"][i],
             int(x["sid"][i])) for i, n in enumerate((12, 9, 5))]
    return {"cfg": tc.to_dict(cfg), "params": _numpy(params), "reqs": reqs,
            "kw": {"max_batch": B, "frames": Tq}}


def _band_tp_inputs():
    from ttsx.models.vocoder import Generator as J
    x = {"mel": randn(30, B, T, 80), "pros": randn(31, B, T, 18),
         "style": randn(32, B, 16)}
    emo = np.exp(randn(33, B, 6))
    x["emo"] = (emo / emo.sum(1, keepdims=True)).astype(np.float32)
    jg = J(jax_cfg(tc.TTSXConfig(vocoder=SHARDING_VOCODER)).vocoder)
    tree = _numpy(init_like(jg, x["mel"], x["pros"], x["style"], x["emo"],
                            seed=5, scale=0.15))
    return {"vocoder": tc.to_dict(SHARDING_VOCODER), "tree": tree, **x}, jg


def _engine_cfg():
    cfg = gan_cfg()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, val_freq=0, checkpoint_freq=0, max_steps=2))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results beside the references."""
    from ttsx.serve import SynthesisRequest as JRequest
    from ttsx.serve import SynthesisServer as JServer
    torch.set_num_threads(1)
    inputs, ref = {"cases": CASES}, {}
    inputs["server"] = _server_inputs()
    inputs["band_tp"], jgen = _band_tp_inputs()
    gcfg = gan_cfg()
    gcfg = dataclasses.replace(gcfg, vocoder=dataclasses.replace(
        gcfg.vocoder, band_tp=True))
    from ttsx_torch.data.synthetic import synthetic_batch
    gbatch = synthetic_batch(gcfg, batch=2, frames=T, seed=4)
    inputs["gan_band_tp"] = {"cfg": tc.to_dict(gcfg), "batch": gbatch}
    ecfg = _engine_cfg()
    stream = (B, 4, 3)
    ebatches = [synthetic_batch(ecfg, B, 4, seed=s) for s in (0, 1)]
    inputs["engine"] = {"cfg": tc.to_dict(ecfg), "stream": stream,
                        "batches": ebatches}
    inputs["oom"] = {"cfg": tc.to_dict(ecfg), "batch": ebatches[0]}
    workdir = tmp_path_factory.mktemp("ranks")
    refiner = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_parallel as t; "
         "t.refiner_reference(sys.argv[1])", str(workdir / "refiner.pt")],
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.pathsep
             .join([str(HERE), str(HERE.parent)])},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    group = Group(workdir, inputs)

    # the references, while the ranks run: first the steps whose draws
    # the ranks replay
    late = {"cases": LATE_CASES}
    with pytest.MonkeyPatch.context() as mp:
        late["acoustic"], ref["acoustic"] = _acoustic_inputs(
            mp, tiny_cfg(), _masked_batch(tiny_cfg()))
    bt = inputs["band_tp"]
    ref["band_tp"] = np.asarray(jax.jit(jgen.apply)(
        bt["tree"], *(jnp.asarray(bt[k]) for k in ("mel", "pros", "style",
                                                     "emo"))))
    srv = inputs["server"]
    jserver = JServer(jax_cfg(_server_cfg()), srv["params"], bf16=False,
                      **srv["kw"])
    ref["server"] = jserver.serve_batch([JRequest(*r) for r in srv["reqs"]])
    log = refiner.communicate(timeout=600)[0]
    assert refiner.returncode == 0, log[-4000:]
    got = torch.load(workdir / "refiner.pt", weights_only=False)
    late["refiner"], ref["refiner"] = got["inputs"], got["ref"]
    group.late(late)
    group.results()
    return group, ref


def _close_dict(got, want, rtol, atol, names=None):
    for k in names or want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def _port_model(name, cfg):
    """The port's model of block ``name`` (its names and shapes only)."""
    from ttsx_torch.models.acoustic import AcousticModel
    from ttsx_torch.models.refiner import ScoreSDERefiner
    if name == "acoustic":
        return AcousticModel(cfg.acoustic)
    return ScoreSDERefiner(cfg.refiner, cfg.acoustic.text_emb_dim,
                           cfg.acoustic.cond_dim)


def _check_step(got, ref, name):
    """Both ranks against the reference's single-device step: metrics,
    gradients (Adam's first moment), every state entry (VQ statistics
    included) within STATE_TOL."""
    model = _port_model(name, tc.from_dict(tc.TTSXConfig, ref["cfg"]))
    want_state = from_flax(model, ref["params"])
    mu = ref["mu"]
    want_mu = {k: v for k, v in from_flax(
        model, {**ref["tree"], "params": mu.get("params", mu)}).items()
        if k in got[0]["mu"]}
    for r in got:
        assert r["exhausted"]
        close_metrics(r["metrics"], ref["metrics"])
        for k, w in want_mu.items():
            # the dp split sums each gradient in another order: its error
            # scales with the tensor's magnitudes, not the element's
            w = np.asarray(w)
            np.testing.assert_allclose(
                r["mu"][k].numpy(), w, rtol=1e-4,
                atol=2e-8 + GRAD_SCALE_TOL * float(np.abs(w).max()),
                err_msg=k)
        _close_dict(r["state"], want_state, 0, STATE_TOL)


# ------------------------------------------------------------------ tests
def test_mesh_without_a_process_group_raises():
    from ttsx_torch.core.config import MeshConfig
    from ttsx_torch.core.mesh import Mesh, make_mesh
    from ttsx_torch.parallel import make_dp_mesh
    assert not torch.distributed.is_initialized()
    for call in (lambda: Mesh(1, 1, "cpu"), lambda: make_mesh(device="cpu"),
                 lambda: make_dp_mesh(device="cpu")):
        with pytest.raises(RuntimeError, match="no process group"):
            call()
    with pytest.raises(ValueError, match="dp\\*tp=6"):
        make_mesh(MeshConfig(dp=3, tp=2), world=8)
    assert tc.from_dict(tc.TTSXConfig, tc.to_dict(tc.TTSXConfig())).mesh \
        == tc.MeshConfig(dp=-1, tp=1, axis_names=("dp", "tp"))


def test_ranks_import_no_jax(run):
    group, _ = run
    assert [res["blocked"] for res in group.results()] == [[], []]


def test_make_mesh_shapes_and_errors(run):
    group, _ = run
    for rank, got in enumerate(group.case("mesh")):
        assert got[(-1, 1)]["shape"] == got[(2, 1)]["shape"] == (2, 1)
        assert got[(1, 2)]["shape"] == (1, 2)
        assert (got[(2, 1)]["dp_rank"], got[(2, 1)]["tp_rank"]) == (rank, 0)
        assert (got[(1, 2)]["dp_rank"], got[(1, 2)]["tp_rank"]) == (0, rank)
        assert got[(2, 1)]["gathered"] == [0, 1]
        assert got[(2, 1)]["tp_gathered"] == [rank]
        assert got[(1, 2)]["tp_gathered"] == [0, 1]
        assert got[(2, 1)]["mean"] == {"x": 0.5}
        assert got["dp3_tp2"].startswith("ValueError: mesh dp*tp=6")
        assert got["cuda_on_gloo"].startswith("RuntimeError: process group "
                                              "backend 'gloo'")
        assert got["dp_mesh"] == (2, 1)
        assert got["dp_mesh_of_3"] == ("ValueError: a dp mesh of 3 ranks "
                                       "in a world of 2")


def test_shard_batch_rows(run):
    group, _ = run
    for rank, got in enumerate(group.case("shard")):
        rows = slice(4 * rank, 4 * rank + 4)
        assert torch.equal(got["x"], torch.arange(16.0).reshape(8, 2)[rows])
        np.testing.assert_array_equal(got["ids"], np.arange(8)[rows])
        assert got["name"] == "bucket" and int(got["scalar"]) == 3
        assert "3 rows does not split over dp=2" in got["odd"]


def test_dp2_acoustic_step_unequal_masks_matches_reference(run):
    """Rank 0's rows have every frame, rank 1's 3 and 5 of 8: the masked
    mel terms divide by the global mask sum, as the reference's do."""
    group, ref = run
    got = group.case("acoustic")
    _check_step(got, ref["acoustic"], "acoustic")
    for r in got:
        np.testing.assert_allclose(r["mel_pred"].numpy(),
                                   ref["acoustic"]["mel_pred"], rtol=1e-5,
                                   atol=1e-5)


def test_dp2_refiner_step_vq_restart_matches_reference(run):
    """The VQ's counts and sums are the global batch's and the dead codes
    restart from global rows (15 and 11 on rank 0, 30 on rank 1): every
    rank's statistics equal the reference's."""
    group, ref = run
    got = group.case("refiner")
    _check_step(got, ref["refiner"], "refiner")
    size = ref["refiner"]["params"]["vq_stats"]["vq"]["stage_0"][
        "cluster_size"]
    assert np.all(np.asarray(size)[list(DEAD)] == 1.0)    # restarted
    for r in got:
        assert torch.all(r["state"]["vq.stage_0.cluster_size"][list(DEAD)]
                         == 1.0)


def test_dp2_refiner_sde_sample_matches_reference(run):
    """The SDE sample after the step, each rank on its rows of the
    reference's noise, against the reference's; and on the port's own
    draws through ``dp_synthesis`` against one process's."""
    from ttsx_torch.models.refiner import ScoreSDERefiner, sde_sample
    from ttsx_torch.train.blocks import as_tensors
    group, ref = run
    rr = ref["refiner"]
    got = group.case("refiner")
    cfg = tc.from_dict(tc.TTSXConfig, rr["cfg"])
    m = ScoreSDERefiner(cfg.refiner, cfg.acoustic.text_emb_dim,
                        cfg.acoustic.cond_dim)
    m.load_state_dict(got[0]["state"])
    b = as_tensors(rr["batch"], "cpu")
    with torch.no_grad():
        one = sde_sample(m.eval(), torch.as_tensor(rr["mel_pred"]),
                         b["prosody"], b["style_id"], b["text_emb"],
                         generator=torch.Generator().manual_seed(11))
    for r in got:
        np.testing.assert_allclose(r["sde"].numpy(), rr["sde"], rtol=0,
                                   atol=SDE_TOL)
        np.testing.assert_allclose(r["sde_own"].numpy(), one.numpy(),
                                   rtol=0, atol=PORT_TOL)


def test_band_tp_generator_matches_reference(run):
    """dp = 1 x tp = 2: each rank runs 2 of the 4 bands (its tower sees 2
    x 4 rows), the gathered waveform equals the reference's unsharded
    generator; 5 bands over tp = 2 raise."""
    group, ref = run
    for got in group.case("band_tp"):
        assert got["tower_rows"] == [2 * B]
        np.testing.assert_allclose(got["wav"].numpy(), ref["band_tp"],
                                   rtol=0, atol=STATE_TOL)
        assert "5 bands do not split over tp=2" in got["odd"]
    assert float(np.abs(ref["band_tp"]).max()) > 1e-3


def test_gan_step_under_band_tp_equals_tp1(run):
    """One discriminator step (R1 by double backward) and one generator
    step at tp = 2: the losses and every state entry (parameters, Adam
    moments, the EMA) equal one process's, so the gather's gradient
    scaling is right for the tower and for band_merge."""
    group, _ = run
    for res in group.case("gan_band_tp"):
        got, want = res["tp2"], res["one"]
        assert got["d"]["r1"] > 0
        close_metrics(got["d"], want["d"], PORT_TOL, 1e-7)
        close_metrics(got["g"], want["g"], PORT_TOL, 1e-7)
        _close_dict(got["state"], want["state"], PORT_TOL, 1e-7)


def test_dp2_server_matches_reference(run):
    """``SynthesisServer(mesh, bf16=False)`` at dp = 2 (2 of the 4-row
    bucket each): every rank returns the 3 requests' waveforms, each the
    reference's f32 server's."""
    group, ref = run
    for got in group.case("server"):
        assert len(got["wavs"]) == len(ref["server"]) == 3
        for g, w in zip(got["wavs"], ref["server"]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_WAV_TOL)


def test_server_chain_gives_the_same_wavs():
    """``chain`` is accepted with the reference's default and changes
    nothing: eager PyTorch has no program to split."""
    import inspect
    from ttsx.serve import SynthesisServer as JServer
    from ttsx_torch.models.pipeline import TTSPipeline
    from ttsx_torch.nn.init import fresh_init_
    from ttsx_torch.serve import SynthesisRequest, SynthesisServer
    want = inspect.signature(JServer).parameters["chain"].default
    assert inspect.signature(SynthesisServer).parameters["chain"].default \
        is want is True
    pipe = TTSPipeline(_server_cfg())
    fresh_init_(pipe, torch.Generator().manual_seed(0))
    reqs = [SynthesisRequest(randn(i, n, 16), randn(i + 1, n, 18),
                             np.full(6, 1 / 6, np.float32), randn(i, 8), i)
            for i, n in enumerate((6, 4))]
    wavs = [SynthesisServer(pipe, device="cpu", bf16=False, max_batch=2,
                            frames=6, chain=c).serve_batch(reqs)
            for c in (True, False)]
    for a, b in zip(*wavs):
        assert np.array_equal(a, b) and float(np.abs(a).max()) > 0


def test_dp2_engine_steps_equal_one_process(run):
    """Two engine steps of the three blocks at dp = 2 (2 rows each of a
    4-row batch): the global-mean metrics, the GAN loss EMAs and every
    state entry equal one process's within 1e-5."""
    group, _ = run
    for res in group.case("engine"):
        got, want = res["dp2"], res["one"]
        for g, w in zip(got["metrics"], want["metrics"]):
            close_metrics(g, w, PORT_TOL, 1e-7)
        np.testing.assert_allclose(got["emas"], want["emas"], rtol=PORT_TOL)
        _close_dict(got["state"], want["state"], PORT_TOL, PORT_TOL)


def test_gan_oom_raises_under_a_mesh(run):
    """Under a mesh of two ranks an out-of-memory GAN step raises (one
    process counts and skips it, tests/test_torch_gan.py): a rank that
    skipped would leave the others waiting in a collective."""
    group, _ = run
    for got in group.case("oom"):
        assert got["raised"] == "out of memory on the card"
        assert got["oom_count"] == 0


def test_dryrun_two_ranks(run):
    """``dryrun_step`` on the reference's tiny dryrun config over dp = 2:
    finite losses on both ranks, and rank 0's check against one rank."""
    group, _ = run
    got = group.case("dryrun")
    assert all(r["finite"] and r["dp"] == 2 for r in got)
    assert got[0]["ok"], got[0]
    assert got[0]["losses"] == got[1]["losses"]


@pytest.mark.slow
def test_dryrun_dp2_tp2_on_four_processes():
    """``dryrun_multichip(4)`` on the CPU: dp = 2 x tp = 2 with band_tp
    (4 bands over 2 ranks), equal to one rank."""
    from ttsx_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(4, device="cpu", timeout=600)
    assert (out["dp"], out["tp"], out["band_tp"]) == (2, 2, True)
    assert out["ok"] and math.isfinite(out["losses"]["g_loss"])
