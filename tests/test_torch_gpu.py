"""Tests that need a CUDA card (``gpu`` marker): the CUDA kernels against
their plain PyTorch versions, and the zoo served through them.

Each test skips without a card. This file imports neither JAX nor the
JAX package, so on a machine without JAX it runs on its own:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up JAX.)
"""
import numpy as np
import pytest
import torch

from ttsx_torch import ops
from ttsx_torch.ops.resblock_stack import (film_resblock_stack,
                                           film_resblock_stack_plain)
from ttsx_torch.ops.upsample import convt_upsample, convt_upsample_plain

pytestmark = pytest.mark.gpu

# |kernel - plain| <= atol + rtol * |plain|: f32 sums in other orders
K1_TOL = dict(rtol=1e-5, atol=1e-5)
K2_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ttsx_torch.core.device import set_f32_numerics
    set_f32_numerics()
    return torch.Generator().manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).cuda()


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **tol)


@pytest.mark.parametrize("f,cin,cout,T,B", [
    (8, 256, 128, 216, 4), (8, 128, 64, 300, 3), (2, 64, 32, 1000, 2),
    (2, 32, 16, 777, 5), (4, 20, 12, 31, 1), (2, 8, 4, 1, 1)])
def test_upsample_kernel_matches_plain(cuda, f, cin, cout, T, B):
    x = _randn(cuda, B, T, cin)
    w = _randn(cuda, 2 * f, cin, cout, scale=(2 * cin) ** -0.5)
    b = _randn(cuda, cout)
    before = convt_upsample.launches
    got = convt_upsample(x, w, b, f)
    torch.cuda.synchronize()
    assert convt_upsample.launches == before + 1
    _close(got, convt_upsample_plain(x, w, b, f), **K1_TOL)


@pytest.mark.parametrize("B,T,C,Tf,Bf,dils", [
    (8, 1727, 128, 27, 2, (1, 3, 5)), (4, 5000, 16, 20, 1, (1, 3, 5)),
    (2, 40, 12, 40, 2, (1, 3, 5)), (3, 300, 64, 300, 3, (2,)),
    (1, 7, 32, 3, 1, (1, 3, 5, 7))])
def test_resblock_stack_kernel_matches_plain(cuda, B, T, C, Tf, Bf, dils):
    n = len(dils)
    args = [_randn(cuda, B, T, C), _randn(cuda, Bf, Tf, 2 * n * C, scale=0.3),
            _randn(cuda, n, 3, C, 2 * C, scale=(3 * C) ** -0.5),
            _randn(cuda, n, 2 * C, scale=0.1),
            _randn(cuda, n, 3, C, C, scale=(3 * C) ** -0.5),
            _randn(cuda, n, C, scale=0.1)]
    before = film_resblock_stack.launches
    got = film_resblock_stack(*args, dils)
    torch.cuda.synchronize()
    assert film_resblock_stack.launches == before + 1
    _close(got, film_resblock_stack_plain(*args, dils), **K2_TOL)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = _randn(cuda, 1, 8, 6)
    with pytest.raises(ValueError, match="Cout % 4"):
        convt_upsample(x, _randn(cuda, 4, 6, 6), _randn(cuda, 6), 2)
    with pytest.raises(TypeError, match="float32"):
        convt_upsample(x.double(), _randn(cuda, 4, 6, 8).double(),
                       _randn(cuda, 8).double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        convt_upsample(x.transpose(1, 2), _randn(cuda, 4, 8, 8),
                       _randn(cuda, 8), 2)


def test_serve_from_zoo_through_kernels(cuda):
    """The zoo model on the card with both kernels: finite, non-silent
    waveforms of len * 256 samples, K1 and K2 launched 4 times each on
    one forward, and the plain path within 5e-4 of it."""
    from ttsx_torch.serve import SynthesisRequest, SynthesisServer
    from ttsx_torch.zoo import serve_from_zoo
    srv = serve_from_zoo(max_batch=2, frames=64)
    ac = srv.cfg.acoustic
    rng = np.random.default_rng(0)
    reqs = [SynthesisRequest(
        rng.standard_normal((n, ac.text_emb_dim)).astype(np.float32),
        rng.standard_normal((n, ac.cond_dim)).astype(np.float32),
        np.full(ac.emotion_dim, 1 / ac.emotion_dim, np.float32),
        rng.standard_normal(ac.speaker_dim).astype(np.float32), i)
        for i, n in enumerate((64, 40))]
    ops.reset_launches()
    outs = srv.serve_batch(reqs)
    assert ops.launch_counts() == {"upsample": 4, "resblock_stack": 4}
    for o, n in zip(outs, (64, 40)):
        assert o.shape == (n * 256,) and np.isfinite(o).all()
        assert float(np.abs(o).max()) > 1e-3
    plain = SynthesisServer(srv.pipe.with_vocoder_kernels(False),
                            max_batch=2, frames=64,
                            scale_stats=srv.scale_stats.cpu())
    for a, b in zip(outs, plain.serve_batch(reqs)):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-4)
