"""The port's optimizer, losses and train blocks against ``ttsx`` on the
CPU, on the same weights and the same draws (see torch_train_helpers.py
for how the draws are shared, and for the tolerances)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_helpers import (JaxDraws, _numpy, batch_of, block_pair,
                                 check_grads, check_params_after_adam,
                                 close_metrics, close_tree, tiny_cfg)

from ttsx_torch.nn.draws import ReplayDraws
from ttsx_torch.weights import from_flax


# ----------------------------------------------------------------- optimizer
def test_optimizer_matches_optax():
    """3 updates on given gradients, the second above the clip norm:
    optax's warmup-cosine schedule (lr 0 on the first update), global-norm
    clip, AdamW with decay on every parameter. 1e-6 relative."""
    from ttsx.train.optim import make_optimizer as jmake, warmup_cosine
    from ttsx_torch.train.optim import make_optimizer, warmup_cosine as pwc
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.1, 3.0, 0.2)]
    tx = jmake(1e-2, 2, 10, 1e-2, 1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v)) for k, v in params.items()}
    opt = make_optimizer(list(tp.values()), 1e-2, 2, 10, 1e-2, 1.0)
    import optax
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
    sched, psched = warmup_cosine(2e-4, 100, 1000), pwc(2e-4, 100, 1000)
    for c in (0, 1, 50, 99, 100, 101, 550, 999, 1000, 5000):
        assert psched(c) == pytest.approx(float(sched(c)), rel=1e-6, abs=1e-12)
    assert psched(0) == 0.0


# -------------------------------------------------------------------- losses
def test_losses_match_reference():
    """Composite acoustic loss (with and without a frame mask) and the
    refiner loss on the same arrays: 1e-6 relative."""
    from types import SimpleNamespace
    from ttsx.train import losses as JL
    from ttsx_torch.train import losses as L
    rng = np.random.default_rng(0)
    a = lambda *s: rng.normal(size=s).astype(np.float32)
    arrays = dict(mel=a(2, 9, 80), noise_pred=a(2, 9, 16),
                  fake_logits=(a(2, 9, 1), a(2, 4, 1), a(2, 3, 1)))
    target, mask = a(2, 9, 80), rng.random((2, 9)) < 0.7
    as_t = lambda x: (tuple(map(torch.as_tensor, x)) if isinstance(x, tuple)
                      else torch.as_tensor(x))
    as_j = lambda x: (tuple(map(jnp.asarray, x)) if isinstance(x, tuple)
                      else jnp.asarray(x))
    for m in (None, mask):
        got, gp = L.composite_acoustic_loss(
            SimpleNamespace(**{k: as_t(v) for k, v in arrays.items()}),
            torch.as_tensor(target), 1.0, 1.0, 0.5, 1.0, 0.1,
            mask=None if m is None else torch.as_tensor(m))
        ref, rp = JL.composite_acoustic_loss(
            SimpleNamespace(**{k: as_j(v) for k, v in arrays.items()}),
            jnp.asarray(target), 1.0, 1.0, 0.5, 1.0, 0.1,
            mask=None if m is None else jnp.asarray(m))
        close_metrics({"loss": got, **gp}, {"loss": ref, **rp}, 1e-6, 0)
    got, gp = L.refiner_loss(as_t(arrays["mel"]), as_t(target),
                             torch.tensor(0.3), 0.7, 0.3,
                             as_t(arrays["mel"]), as_t(target))
    ref, rp = JL.refiner_loss(as_j(arrays["mel"]), as_j(target),
                              jnp.asarray(0.3), 0.7, 0.3,
                              as_j(arrays["mel"]), as_j(target))
    close_metrics({"loss": got, **gp}, {"loss": ref, **rp}, 1e-6, 0)


# -------------------------------------------------------------- train blocks
def test_acoustic_train_step_parity(monkeypatch):
    """Two updates on the same draws (dropout, attention dropout,
    stochastic depth, the diffusion step and noise): losses, gradients,
    the lr-0 first update, parameters after the second."""
    cfg = tiny_cfg()
    batch = batch_of(cfg)
    jb, st, pb, tree = block_pair("acoustic", cfg, batch)
    draws = JaxDraws(monkeypatch)
    before = {k: v.clone() for k, v in pb.model.state_dict().items()}
    for step in range(2):
        (st, out), rec = draws.call("a", jb.train_step, st, batch)
        kinds = {r[0] for r in rec}
        assert kinds == {"bernoulli", "randint", "normal"}
        pb.state.draws = ReplayDraws(rec)
        pout = pb.train_step(batch)
        assert pb.state.draws.exhausted()
        close_metrics(pout["metrics"], out["metrics"])
        np.testing.assert_allclose(pout["mel_pred"].numpy(),
                                   np.asarray(out["mel_pred"]), rtol=1e-5,
                                   atol=1e-5)
        if step == 0:
            mu_ref = check_grads(pb, st, tree)
            assert pout["lr"] == 0.0
            for k, v in pb.model.state_dict().items():
                assert torch.equal(v, before[k]), k
    check_params_after_adam(pb, st.params, mu_ref, pout["lr"])


def test_acoustic_train_step_accum_parity(monkeypatch):
    """Two equal-shape micro-batches, one update: the reference reuses one
    key for the window, so both micro-batches run on the same draws; the
    port rewinds its draws per micro-batch. Loss, gradients, and the
    last micro-batch's prediction."""
    cfg = tiny_cfg(accum=2)
    micro = [batch_of(cfg, seed=s) for s in (0, 1)]
    jb, st, pb, tree = block_pair("acoustic", cfg, micro[0])
    draws = JaxDraws(monkeypatch)
    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro])
               for k in micro[0]}
    (st, out), rec = draws.call("a", jb.train_step_accum, st, stacked)
    pb.state.draws = ReplayDraws(rec)
    pout = pb.train_step_accum(micro)
    assert pb.state.draws.exhausted() and len(pout["mel_pred"]) == 2
    close_metrics(pout["metrics"], out["metrics"])
    np.testing.assert_allclose(pout["mel_pred"][1].numpy(),
                               np.asarray(out["mel_pred"]), rtol=1e-5,
                               atol=1e-5)
    check_grads(pb, st, tree)


def test_refiner_train_step_parity(monkeypatch):
    """Two updates on the same draws (the refiner's t and noise, Gumbel
    uniforms, gate and S4 dropouts): losses, gradients, the EMA codebook
    statistics after each step (updated inside the forward; the loss reads
    the codebook before the update), parameters after the second."""
    cfg = tiny_cfg()
    batch = batch_of(cfg)
    jb, st, pb, tree = block_pair("refiner", cfg, batch, seed=1)
    mel_pred = batch["mel"] + 0.1 * np.random.default_rng(3).normal(
        size=batch["mel"].shape).astype(np.float32)
    draws = JaxDraws(monkeypatch)
    vq_before = pb.model.vq.stage_0.embed_sum.clone()
    for step in range(2):
        (st, out), rec = draws.call(
            "r", jb.train_step, st, batch, jnp.asarray(mel_pred),
            jnp.asarray(0.5, jnp.float32), jnp.asarray(0.7, jnp.float32))
        assert {r[0] for r in rec} == {"uniform", "normal", "bernoulli"}
        pb.state.draws = ReplayDraws(rec)
        pout = pb.train_step(batch, torch.as_tensor(mel_pred), 0.5, 0.7)
        assert pb.state.draws.exhausted()
        close_metrics(pout["metrics"], out["metrics"])
        vq = from_flax(pb.model, _numpy(st.params))
        close_tree(pb.model.state_dict(), vq, 1e-5, 1e-5,
                   [k for k in vq if k.startswith("vq.")])
        if step == 0:
            mu_ref = check_grads(pb, st, tree)
    assert not torch.allclose(pb.model.vq.stage_0.embed_sum, vq_before)
    check_params_after_adam(pb, st.params, mu_ref, pout["lr"])
