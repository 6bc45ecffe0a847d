"""Shared helpers of the trainer parity tests (tests/test_torch_train.py,
tests/test_torch_engine.py).

Both packages start from the same weights (the reference's init tree,
filled with seeded values by ``init_like``) and run on the same draws:
inside a test ``jax.random``'s samplers are replaced by numpy draws
(``JaxDraws``), recorded, and handed to the port's blocks as a
``ReplayDraws``. Under ``jit`` a trace bakes its draws in, so a call that
reuses a compiled trace reuses that trace's draws, and the port is given
the same. Nothing in ``ttsx`` changes.

Tolerances: losses 1e-5 relative; gradients (read from Adam's first
moment after update 1, 0.1 x the clipped gradient) 1e-4 relative +
2e-8 absolute; after update 2 every parameter whose gradient is above
1e-6 within 1e-6 (Adam's update there is lr x sign(g), the same on both
sides), and a parameter with a gradient at f32 noise level (e.g. the
attention key bias, which the softmax ignores) within one update of 2 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity_helpers import init_like

from ttsx.core import config as jc
from ttsx_torch.core import config as tc
from ttsx_torch.weights import from_flax, load_flax


def tiny_cfg(accum: int = 1, dropout: float = 0.1) -> tc.TTSXConfig:
    """tests/test_train.py's tiny config, with dropout and stochastic depth
    on so that their masks are held against the reference too."""
    s4 = tc.S4Config(heads=2, norm_groups=2, causal=True, dropout=dropout)
    return tc.TTSXConfig(
        audio=tc.AudioConfig(sample_rate=16000, n_fft=256, win_length=256,
                             hop_length=64, n_mels=80),
        acoustic=tc.AcousticConfig(text_emb_dim=16, hidden_channels=16,
                                   conformer_layers=1, transformer_dim=32,
                                   num_layers=2, attention_heads=2,
                                   speaker_dim=8, dropout=dropout,
                                   base_sd_prob=0.5 if dropout else 0.0),
        refiner=tc.RefinerConfig(levels=1, cond_dim=16, hidden_channels=16,
                                 hsf_hidden=8, style_dim=8, beta_hidden=8,
                                 s4=s4, sde_steps=2, vq_dims=(80,),
                                 vq_codes=(16,)),
        train=tc.TrainConfig(warmup_steps=2, max_steps=8, val_freq=0,
                             checkpoint_freq=0, lr=1e-3,
                             grad_accum_steps=accum, batch_size=4))


# tests/test_train.py's tiny vocoder: fewer discriminators and STFT sizes
TINY_VOCODER = tc.VocoderConfig(hidden_dim=16, cond_dim=8, style_dim=16,
                                disc_ch_growth=2, disc_periods=(2, 3),
                                disc_kernel_sizes=(15,), stft_sizes=(512,))


def gan_cfg(accum: int = 1, **vocoder) -> tc.TTSXConfig:
    """``tiny_cfg(accum)`` with ``TINY_VOCODER`` (fields overridden by
    ``vocoder``)."""
    import dataclasses
    return dataclasses.replace(tiny_cfg(accum), vocoder=dataclasses.replace(
        TINY_VOCODER, **vocoder))


def jax_cfg(cfg):
    return jc.from_dict(jc.TTSXConfig, tc.to_dict(cfg))


def batch_of(cfg, seed=0, frames=8, batch=2):
    from ttsx_torch.data.synthetic import synthetic_batch
    return synthetic_batch(cfg, batch=batch, frames=frames, seed=seed,
                           with_wav=False)


class JaxDraws:
    """``jax.random.{uniform,normal,randint,bernoulli}`` replaced by numpy
    draws seeded by call count, each recorded as (kind, shape, value)."""

    def __init__(self, monkeypatch, seed: int = 1):
        self.seed, self.records, self.last = seed, [], {}
        for name in ("uniform", "normal", "randint", "bernoulli"):
            monkeypatch.setattr(jax.random, name, getattr(self, name))

    def _draw(self, kind, shape, make):
        v = make(np.random.default_rng([self.seed, len(self.records)]))
        self.records.append((kind, tuple(shape), torch.as_tensor(v)))
        return v

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                maxval=1.0):
        return jnp.asarray(self._draw("uniform", shape, lambda r: np.maximum(
            minval, r.uniform(minval, maxval, shape)).astype(np.float32)),
            dtype)

    def normal(self, key, shape=(), dtype=jnp.float32):
        return jnp.asarray(self._draw("normal", shape, lambda r:
                                      r.standard_normal(shape).astype(
                                          np.float32)), dtype)

    def randint(self, key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(self._draw("randint", shape, lambda r: r.integers(
            minval, maxval, shape).astype(np.int32)), dtype)

    def bernoulli(self, key, p=0.5, shape=None, **kw):
        return jnp.asarray(self._draw("bernoulli", shape,
                                      lambda r: r.random(shape) < float(p)))

    def call(self, label, fn, *args):
        """``fn(*args)`` and the draws it ran on: new records if it traced,
        else the last trace's under ``label``."""
        n0 = len(self.records)
        out = fn(*args)
        self.last[label] = self.records[n0:] or self.last[label]
        return out, self.last[label]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init_tree(name, jblock, batch, seed):
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    if name == "acoustic":
        return init_like(jblock.model, b["text_emb"], b["prosody"],
                         b["emotion_probs"], target_mel=b["mel"],
                         speaker=b["speaker"], seed=seed)
    return init_like(jblock.model, b["mel"], b["prosody"], b["style_id"],
                     b["text_emb"], seed=seed)


def seed_block_init(name, jblock, batch, seed):
    """The reference block's ``init_state`` returns ``init_like``'s tree
    (no init compile); returns that tree as numpy."""
    tree = _numpy(_init_tree(name, jblock, batch, seed))
    object.__setattr__(jblock.model, "init", lambda *a, **k: tree)
    return tree


def block_pair(name, cfg, batch, seed=0):
    from ttsx.train import blocks as jblocks
    from ttsx_torch.train.engine import BlockRegistry
    jcls = {"acoustic": jblocks.AcousticBlock,
            "refiner": jblocks.RefinerBlock}[name]
    jb = jcls(jax_cfg(cfg))
    tree = seed_block_init(name, jb, batch, seed)
    pb = BlockRegistry.create(name, cfg, "cpu", seed)
    load_flax(pb.model, tree)
    return jb, jb.init_state(jax.random.PRNGKey(seed), batch), pb, tree


def mu_tree(opt_state):
    """Adam's first moment from ``chain(clip, chain(adam, decay, lr))``,
    optax.masked or not."""
    chain = getattr(opt_state, "inner_state", opt_state)
    return chain[1][0].mu


def port_mu(pb):
    adamw = pb.state.tx.adamw
    return {n: adamw.state[p]["exp_avg"]
            for n, p in pb.model.named_parameters()}


def close_tree(got: dict, ref: dict, rtol, atol, names=None):
    for k in names or ref:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   ref[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


def check_grads(pb, jstate, tree):
    mu = _numpy(mu_tree(jstate.opt_state))
    full = {**tree, "params": mu.get("params", mu)}
    got = port_mu(pb)
    ref = {k: v for k, v in from_flax(pb.model, full).items() if k in got}
    close_tree(got, ref, 1e-4, 2e-8)
    return ref


def check_params_after_adam(pb, jparams, mu_ref, lr):
    ref = from_flax(pb.model, _numpy(jparams))
    got = pb.model.state_dict()
    for k, g in mu_ref.items():
        diff = (got[k] - ref[k]).abs()
        firm = g.abs() > 1e-7           # 0.1 x |g| > 1e-7
        assert float(torch.where(firm, diff, 0.0).max()) <= 1e-6, k
        assert float(diff.max()) <= 2 * lr + 1e-6, k
    return got, ref


def close_metrics(got, ref, rtol=1e-5, atol=1e-6):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


