"""The S4 layer's recurrent routes and K4's plain version against ``ttsx``.

On the CPU: the port's ``scan_dw_conv`` against the reference's
associative scan; ``ops.s4_scan`` (K4's wrapper, which on a CPU tensor
runs ``scan_dw_conv``) against the Pallas kernel ``s4_scan_pallas`` in
interpret mode and against the FFT convolution; the ``S4`` layer in
``scan`` and ``pallas`` modes against the reference layer in the same
mode (on the CPU the reference's ``pallas`` mode runs its associative
scan, ``ttsx/ops/s4_kernel.py:s4_scan``). The CUDA kernel itself is
checked on the card by tests/test_torch_gpu.py.

Tolerances are the reference's own tests' (tests/test_ops.py): 1e-4
against the scan and the Pallas kernel (f32 sums in another order), 1e-3
against the FFT convolution.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity_helpers import close, perturb, port, randn, t

from ttsx_torch.nn.s4 import fft_dw_conv, ssm_kernel
from ttsx_torch.ops.s4_scan import chunk_len, s4_scan, scan_dw_conv

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
FFT_TOL = dict(rtol=1e-3, atol=1e-3)


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


@pytest.mark.parametrize("B,T,C,sms", [(1, 864, 280, 132), (1, 864, 1136, 132),
                                       (4, 864, 1136, 132), (2, 1, 8, 132),
                                       (1, 100, 8, 4)])
def test_k4_chunks_cover_time_in_groups_of_32(B, T, C, sms):
    """The kernel's time chunks: multiples of 32 that cover T, one chunk
    when B * C warps alone give 16 per SM, more below that."""
    L = chunk_len(B, T, C, sms)
    n = -(-T // L)
    assert L % 32 == 0 and L >= 32 and (n - 1) * L < T <= n * L
    assert (n == 1) == (B * C >= 16 * sms or T <= 32)


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
