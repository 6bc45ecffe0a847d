"""The S4 layer's recurrent routes and K4's plain version against ``ttsx``.

On the CPU: the port's ``scan_dw_conv`` against the reference's
associative scan; ``ops.s4_scan`` (K4's wrapper, which on a CPU tensor
runs ``scan_dw_conv``) against the Pallas kernel ``s4_scan_pallas`` in
interpret mode and against the FFT convolution; the ``S4`` layer in
``scan`` and ``pallas`` modes against the reference layer in the same
mode (on the CPU the reference's ``pallas`` mode runs its associative
scan, ``ttsx/ops/s4_kernel.py:s4_scan``). K4's chunked form (the two
products per head, the lag kernel and the carry that
``csrc/s4_scan.cu`` computes), written out here in float32 torch,
against the Pallas kernel and the recurrence, and the kernel's launch
geometry. The CUDA kernel itself is checked on the card by
tests/test_torch_gpu.py.

Tolerances are the reference's own tests' (tests/test_ops.py): 1e-4
against the scan and the Pallas kernel (f32 sums in another order), 1e-3
against the FFT convolution.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import close, perturb, port, randn, t

from ttsx_torch.nn.s4 import fft_dw_conv, ssm_kernel
from ttsx_torch.ops.s4_scan import (CHUNK, MAX_MODES, ROWS, launch_geometry,
                                    s4_scan, scan_dw_conv)

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
FFT_TOL = dict(rtol=1e-3, atol=1e-3)
K4_TOL = dict(rtol=1e-4, atol=1e-4)   # chip_smoke.py's K4_TOL


def _ssm(seed, B, T, H, d, e, a_scale, c_scale):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, T, H * e)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((H, d))) * a_scale).astype(np.float32)
    b = np.ones((H, d), np.float32)
    c = (rng.standard_normal((H, d, e)) * c_scale).astype(np.float32)
    return u, a, b, c


# test_ops.py's two shapes, then T > 128 and not a multiple of 128 with an
# odd e (the zoo refiner's bands 1-2 have e = 71 and 284)
SHAPES = [(2, 96, 2, 4, 4, 0.3, 0.5), (1, 128, 2, 3, 4, 0.5, 0.3),
          (2, 200, 3, 5, 7, 0.3, 0.4)]


@pytest.mark.parametrize("shape", SHAPES)
def test_scan_dw_conv_matches_reference(shape):
    from ttsx.nn.s4 import scan_dw_conv as jscan
    u, a, b, c = _ssm(0, *shape)
    close(scan_dw_conv(t(u), t(a), t(b), t(c)),
          jax.jit(jscan)(u, a, b, c), **SCAN_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_k4_plain_matches_pallas_and_fft(shape):
    from ttsx.ops.s4_kernel import s4_scan_pallas
    u, a, b, c = _ssm(1, *shape)
    got = s4_scan(t(u), t(a), t(b), t(c))
    ref = s4_scan_pallas(*map(jnp.asarray, (u, a, b, c)), interpret=True)
    close(got, ref, **SCAN_TOL)
    w = ssm_kernel(t(a), t(b), t(c), u.shape[1])
    close(got, fft_dw_conv(t(u), w, causal=True).numpy(), **FFT_TOL)


@pytest.mark.parametrize("B,T,C,d,channels", [
    (1, 864, 280, 70, 2), (4, 864, 280, 70, 4), (1, 864, 1136, 284, 4),
    (4, 864, 1136, 284, 8), (2, 1, 8, 3, 2), (1, CHUNK, 284, 71, 2),
    (3, CHUNK + 1, 568, 142, 4), (66, 2 * CHUNK + 1, 256, MAX_MODES, 8)])
def test_k4_launch_geometry(B, T, C, d, channels):
    """On an H100's 132 SMs: chunks of CHUNK steps cover T; CTAs take 8
    channels where those CTAs number four per SM, else 4 where they cover
    the SMs, else 2; groups of ROWS / channels chunks cover the chunks and
    channel tiles cover a head; a CTA's shared memory fits an H100 block's
    opt-in limit up to MAX_MODES modes and outgrows it beyond."""
    H, e = 4, C // 4
    g = launch_geometry(B, T, C, H, d, 132)
    n, tiles, per = g.n_chunks, g.tiles, ROWS // g.channels
    assert g.L == CHUNK == 32 and (n - 1) * g.L < T <= n * g.L
    assert g.channels == channels
    assert (g.groups - 1) * per < n <= g.groups * per
    assert (tiles - 1) * g.channels < e <= tiles * g.channels
    limit = 227 * 1024
    assert g.smem <= limit
    if channels == 8:
        assert launch_geometry(B, T, C, H, MAX_MODES + 1, 132).smem > limit


def chunked_scan(u, a, b, c, L=CHUNK):
    """The function of K4 in the chunked form its CUDA kernel computes, in
    float32 torch: per head, the end state of each chunk from zero
    ``E_k = Vend . U_k`` (Vend[s, m] = dec^(L-1-s)), the carry
    ``R_{k+1} = dec^L R_k + E_k``, the output ``W . (cc R_k)`` (W[t, m] =
    dec^(t+1)) plus the local part, a causal convolution of U_k with the
    lag kernel ``K = W0 . cc`` (W0[l, m] = dec^l). b folds into the
    readout, cc = c_full b."""
    B, T, C = u.shape
    H, d = a.shape
    e = C // H
    n = -(-T // L)
    U = torch.nn.functional.pad(u, (0, 0, 0, n * L - T)).reshape(B, n, L, H, e)
    dec = torch.exp(torch.clamp(a, -50.0, 50.0))             # [H, d]
    cc = c * b[:, :, None]                                    # [H, d, e]
    W0 = dec[:, None, :] ** torch.arange(L, dtype=u.dtype)[None, :, None]
    W = W0 * dec[:, None, :]                                  # [H, L, d]
    vend = W0.flip(1)
    E = torch.einsum("hsm,bkshe->bkhme", vend, U)
    dec_l = (dec ** L)[None, :, :, None]
    R, carried = torch.zeros_like(E[:, 0]), []
    for k in range(n):
        carried.append(R)
        R = dec_l * R + E[:, k]
    R = torch.stack(carried, 1)                               # [B, n, H, d, e]
    Y = torch.einsum("htm,bkhme->bkthe", W, cc[None, None] * R)
    K = torch.einsum("hlm,hme->hle", W0, cc)                  # [H, L, e]
    lag = torch.arange(L)[:, None] - torch.arange(L)[None, :]
    toeplitz = K[:, lag.clamp(min=0)] * (lag >= 0)[None, :, :, None]
    Y = Y + torch.einsum("htse,bkshe->bkthe", toeplitz, U)
    return Y.reshape(B, n * L, C)[:, :T]


@pytest.mark.parametrize("shape", SHAPES)
def test_k4_chunked_form_matches_pallas(shape):
    from ttsx.ops.s4_kernel import s4_scan_pallas
    u, a, b, c = _ssm(2, *shape)
    b = b + 0.1 * np.random.default_rng(3).standard_normal(b.shape).astype(
        np.float32)
    ref = s4_scan_pallas(*map(jnp.asarray, (u, a, b, c)), interpret=True)
    close(chunked_scan(t(u), t(a), t(b), t(c)), ref, **K4_TOL)


@pytest.mark.parametrize("T,C,d", [(864, 284, 71), (864, 1136, 284)])
def test_k4_chunked_form_matches_recurrence(T, C, d):
    """The zoo refiner's narrowest and widest S4 layers: the layer's own
    decays, LayerNorm-scale input, a readout of scale d^-0.5."""
    rng = np.random.default_rng(4)
    H, e = 4, C // 4
    u = t(rng.standard_normal((1, T, C)).astype(np.float32))
    a = t(np.tile(-np.linspace(1.0, d, d, dtype=np.float32) / d, (H, 1)))
    b = torch.ones(H, d)
    c = t((rng.standard_normal((H, d, e)) * d ** -0.5).astype(np.float32))
    close(chunked_scan(u, a, b, c), scan_dw_conv(u, a, b, c).numpy(),
          **K4_TOL)


def _s4_pair(mode, causal=True, T=20, seed=7):
    from ttsx.core.config import S4Config as JS4Config
    from ttsx.nn.s4 import S4 as JS4
    from ttsx_torch.core.config import S4Config
    from ttsx_torch.nn.s4 import S4
    kw = dict(heads=2, l_max=16, causal=causal, norm_groups=2,
              kernel_mode=mode)
    x = randn(seed, 2, T, 8)
    jm = JS4(8, JS4Config(**kw))
    return jm, x, S4, S4Config(**kw)


@pytest.mark.parametrize("mode", ["scan", "pallas"])
def test_s4_layer_recurrent_modes_match_reference(mode):
    """T=20 > l_max=16 takes the tail-extended positional bias too."""
    jm, x, S4, cfg = _s4_pair(mode)
    fft = dataclasses.replace(cfg, kernel_mode="fft")
    from ttsx.nn.s4 import S4 as JS4
    from ttsx.core.config import S4Config as JS4Config
    v = perturb(jax.jit(JS4(8, JS4Config(**dataclasses.asdict(fft))).init)(
        jax.random.PRNGKey(7), x), scale=0.3)
    ref = jax.jit(jm.apply)(v, x)
    got = port(S4(8, cfg), v)(t(x))
    close(got, ref, **SCAN_TOL)
    # the same weights on the fft route compute the same function
    close(got, port(S4(8, fft), v)(t(x)).detach().numpy(), **FFT_TOL)


@pytest.mark.parametrize("mode", ["scan", "pallas"])
def test_s4_recurrent_modes_refuse_non_causal(mode):
    jm, x, S4, _ = _s4_pair(mode, causal=False)
    with pytest.raises(ValueError, match="causal-only"):
        jm.init(jax.random.PRNGKey(0), x)
    from ttsx_torch.core.config import S4Config
    with pytest.raises(ValueError, match="causal-only"):
        S4(8, S4Config(heads=2, norm_groups=2, causal=False,
                       kernel_mode=mode))
