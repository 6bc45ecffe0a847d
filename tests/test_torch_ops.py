"""The port's kernels K1 (ConvT upsample), K2 (FiLM resblock stack) and K5
(one FiLM resblock); K4 (the S4 recurrence) has its own file,
tests/test_torch_s4.py, and joins the dispatch tests here; and the SAME
convolution of the discriminators' wide layers (``ops.conv1d_same``,
which replaces no TPU kernel): its plain version, autograd ``Function``
and input-gradient identity against ``F.conv1d``.

On the CPU: each kernel's plain PyTorch version against the Pallas TPU
kernel it replaces, run in interpret mode as tests/test_ops.py runs it;
the wrappers' device dispatch (a CPU tensor runs the plain version,
anything else launches the kernel or raises — never a quiet fallback).
The CUDA kernels themselves are checked on the card by
tests/test_torch_gpu.py.
"""
import ctypes
import importlib

import jax.numpy as jnp
import pytest
import torch

from torch_parity_helpers import close, randn, t

from ttsx_torch.ops import (build, conv1d_same, conv1d_same_input_grad,
                            convt_upsample, film_resblock, film_resblock_stack,
                            s4_scan)
from ttsx_torch.ops.resblock_stack import film_resblock_stack_plain
import ttsx_torch.ops.resblock as rb_mod
# the module (``ops.conv1d_same`` names the wrapper)
cs_mod = importlib.import_module("ttsx_torch.ops.conv1d_same")
import ttsx_torch.ops.resblock_stack as rs_mod
# the module (``ops.s4_scan`` names the wrapper)
s4_mod = importlib.import_module("ttsx_torch.ops.s4_scan")
import ttsx_torch.ops.upsample as up_mod

# f32 sums in other orders: 1e-5 relative / 1e-5 absolute for K1's two
# products per row and K5's two convs (test_ops.py's 1e-5 for the block);
# K2 chains 6 convs, so 1e-4 / 1e-4 as test_ops.py does
K1_TOL = dict(rtol=1e-5, atol=1e-5)
K2_TOL = dict(rtol=1e-4, atol=1e-4)
K5_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f,cin,cout,T", [(8, 16, 8, 33), (8, 12, 4, 3),
                                          (2, 8, 4, 300), (2, 4, 4, 7),
                                          (4, 8, 6, 10)])
def test_upsample_plain_matches_pallas(f, cin, cout, T):
    from ttsx.ops.upsample_kernel import upsample_lrelu_pallas
    x = randn(f, 2, T, cin)
    w = randn(f + 1, 2 * f, cin, cout, scale=0.3)
    b = randn(f + 2, cout)
    ref = upsample_lrelu_pallas(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), f, interpret=True,
                                lrelu=False)
    got = convt_upsample(t(x), t(w), t(b), f)
    assert got.shape == (2, T * f, cout)
    close(got, ref, **K1_TOL)


def _stack_inputs(seed, B, T, C, Tf, n=3, Bf=None):
    Bf = Bf or B
    return (randn(seed, B, T, C), randn(seed + 1, Bf, Tf, 2 * n * C, scale=0.3),
            randn(seed + 2, n, 3, C, 2 * C, scale=0.2),
            randn(seed + 3, n, 2 * C, scale=0.1),
            randn(seed + 4, n, 3, C, C, scale=0.2),
            randn(seed + 5, n, C, scale=0.1))


@pytest.mark.parametrize("B,T,C,Tf", [
    (2, 40, 16, 40),       # one tile, full-rate film
    (2, 1040, 16, 1040),   # several tiles: halos across tile edges
    (1, 1024, 16, 64),     # mel-rate film, gathered (t * Tf) // T
    (2, 300, 8, 7),        # coarse film with T not a multiple of Tf
])
def test_resblock_stack_plain_matches_pallas(B, T, C, Tf):
    from ttsx.ops.resblock_stack_kernel import film_resblock_stack_pallas
    args = _stack_inputs(20 + T, B, T, C, Tf)
    dils = (1, 3, 5)
    ref = film_resblock_stack_pallas(*map(jnp.asarray, args), dils,
                                     interpret=True)
    got = film_resblock_stack(*map(t, args), dils)
    close(got, ref, **K2_TOL)


def test_resblock_stack_film_batch_fold():
    """x rows b read film row b % Bf: the generator's band fold
    (band-major, 4 bands x batch 2) against an explicitly tiled film."""
    x, film, *w = map(t, _stack_inputs(40, 8, 50, 8, 10, Bf=2))
    got = film_resblock_stack_plain(x, film, *w, (1, 3, 5))
    ref = film_resblock_stack_plain(x, film.repeat(4, 1, 1), *w, (1, 3, 5))
    assert torch.equal(got, ref)


def _block_inputs(seed, B, T, C):
    return (randn(seed, B, T, C), randn(seed + 1, B, T, C, scale=0.3),
            randn(seed + 2, B, T, C, scale=0.3),
            randn(seed + 3, 3, C, 2 * C, scale=0.2),
            randn(seed + 4, 2 * C, scale=0.1),
            randn(seed + 5, 3, C, C, scale=0.2), randn(seed + 6, C, scale=0.1))


@pytest.mark.parametrize("B,T,C,dil", [
    (2, 40, 16, 1), (2, 40, 16, 3), (2, 40, 16, 5),
    (1, 1100, 8, 3),     # three 512-row tiles: halos across tile edges
])
def test_resblock_plain_matches_pallas(B, T, C, dil):
    from ttsx.ops.resblock_kernel import film_resblock_pallas
    args = _block_inputs(50 + dil + T, B, T, C)
    ref = film_resblock_pallas(*map(jnp.asarray, args), dil, interpret=True)
    close(film_resblock(*map(t, args), dil), ref, **K5_TOL)


def test_film_residual_block_use_pallas_matches_flax():
    """The port's block with ``use_pallas`` (K5's route) against the flax
    block on the same weights, the conditioning at a lower rate."""
    import jax
    from torch_parity_helpers import perturb, port
    from ttsx.models.vocoder import FiLMResidualBlock as JBlock
    from ttsx_torch.models.vocoder import FiLMResidualBlock
    x, cond = randn(60, 2, 48, 16), randn(61, 2, 6, 8)
    jm = JBlock(16, 3, 8)
    v = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), x, cond), scale=0.2)
    ref = jax.jit(jm.apply)(v, x, cond)
    got = port(FiLMResidualBlock(16, 3, 8, use_pallas=True), v)(t(x), t(cond))
    close(got, ref, **K5_TOL)


def test_wrappers_raise_off_cpu_and_cuda():
    x = torch.empty(1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        convt_upsample(x, torch.empty(4, 4, 4, device="meta"),
                 torch.empty(4, device="meta"), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        film_resblock_stack(x, torch.empty(1, 4, 24, device="meta"),
                       *(torch.empty(1, device="meta"),) * 4, (1, 3, 5))
    with pytest.raises(ValueError, match="unsupported device"):
        film_resblock(x, x, x, *(torch.empty(1, device="meta"),) * 4, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        s4_scan(x, *(torch.empty(2, 2, device="meta"),) * 2,
                torch.empty(2, 2, 2, device="meta"))
    w = torch.empty(4, 4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv1d_same(x, w, torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        conv1d_same_input_grad(x, w)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel path
    of a wrapper on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_without_kernel_raises(monkeypatch):
    """With the kernel library unavailable the wrapper raises; it never
    runs the plain version instead."""
    def no_library(name):
        raise build.KernelCompileError(f"no {name} library")

    def forbidden(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(up_mod, "convt_upsample_plain", forbidden)
    monkeypatch.setattr(rs_mod, "film_resblock_stack_plain", forbidden)
    monkeypatch.setattr(cs_mod, "conv1d_same_plain", forbidden)
    monkeypatch.setattr(cs_mod, "conv1d_same_input_grad_plain", forbidden)
    cuda = lambda a: torch.Tensor._make_subclass(_CudaLooking, t(a))
    with pytest.raises(build.KernelCompileError):
        convt_upsample(cuda(randn(0, 1, 5, 8)), cuda(randn(1, 4, 8, 4)),
                 cuda(randn(2, 4)), 2)
    with pytest.raises(build.KernelCompileError):
        film_resblock_stack(*map(cuda, _stack_inputs(3, 1, 9, 4, 9)), (1, 3, 5))
    x, w, b = _conv_inputs(4, 1, 4, 9, 8, 3)
    with pytest.raises(build.KernelCompileError):
        conv1d_same(*(cuda(a.numpy()) for a in (x, w, b)))
    with pytest.raises(build.KernelCompileError):
        conv1d_same_input_grad(cuda(randn(5, 1, 8, 9)), cuda(w.numpy()))
    # a width the kernel does not take (no multiple of 4) is refused
    x, w, b = _conv_inputs(4, 1, 6, 9, 8, 3)
    with pytest.raises(ValueError, match="multiple of 4"):
        conv1d_same(*(cuda(a.numpy()) for a in (x, w, b)))
    with pytest.raises(ValueError, match="multiple of 4"):
        conv1d_same_input_grad(cuda(randn(5, 1, 6, 9)),
                               cuda(_conv_inputs(4, 1, 8, 9, 6, 3)[1].numpy()))
    assert convt_upsample.launches == 0 and film_resblock_stack.launches == 0
    assert conv1d_same.launches == 0 and conv1d_same_input_grad.launches == 0


def _conv_inputs(seed, B, cin, T, cout, k, dtype=torch.float32):
    """x [B, Cin, T], w [Cout, Cin, k], b [Cout], signed."""
    return (t(randn(seed, B, cin, T)).to(dtype),
            t(randn(seed + 1, cout, cin, k, scale=(cin * k) ** -0.5)).to(dtype),
            t(randn(seed + 2, cout, scale=0.1)).to(dtype))


def _padded_conv(x, w, b):
    """Today's ``SNConv`` path for stride 1: ``F.pad`` + ``F.conv1d``."""
    from ttsx_torch.nn.conv import same_pads
    return torch.nn.functional.conv1d(
        torch.nn.functional.pad(x, same_pads(x.shape[-1], w.shape[-1])), w, b)


# the discriminators' k 15 and 41 (and 3) at reduced widths and lengths,
# T shorter than k included
CONV_SHAPES = [(2, 6, 50, 5, 15), (1, 4, 30, 7, 41), (3, 5, 17, 4, 3),
               (2, 3, 9, 2, 15)]


@pytest.mark.parametrize("B,cin,T,cout,k", CONV_SHAPES)
def test_conv1d_same_plain_and_function_match_the_padded_conv(B, cin, T,
                                                              cout, k):
    """The plain version and the autograd ``Function`` (on the CPU it runs
    the plain forward) equal ``F.pad`` + ``F.conv1d`` in value, and the
    Function's input and weight gradients (the input gradient by the
    transposed, tap-reversed convolution) equal autograd's; float64."""
    x, w, b = (a.requires_grad_() for a in _conv_inputs(
        10 + k, B, cin, T, cout, k, torch.float64))
    ref = _padded_conv(x, w, b)
    assert torch.equal(cs_mod.conv1d_same_plain(x, w, b), ref)
    assert torch.equal(conv1d_same(x, w, b), ref)
    got = cs_mod.ConvSame.apply(x, w, b)
    assert torch.equal(got, ref)
    dy = t(randn(20 + k, B, cout, T)).double()
    want = torch.autograd.grad(ref, (x, w, b), dy)
    have = torch.autograd.grad(got, (x, w, b), dy)
    for h, r in zip(have, want):
        torch.testing.assert_close(h, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("B,cin,T,cout,k", CONV_SHAPES[:2])
def test_conv1d_same_input_grad_is_the_flipped_convolution(B, cin, T, cout,
                                                           k):
    """dx of the SAME convolution is the same convolution of dy with w
    transposed and its taps reversed: ``conv1d_same_input_grad`` against
    autograd's dx of ``F.conv1d``, float64 and float32."""
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        x, w, _ = _conv_inputs(30 + k, B, cin, T, cout, k, dtype)
        x.requires_grad_()
        dy = t(randn(40 + k, B, cout, T)).to(dtype)
        (dx,) = torch.autograd.grad(_padded_conv(x, w, None), x, dy)
        torch.testing.assert_close(conv1d_same_input_grad(dy, w), dx,
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("k", [15, 41])
def test_conv_same_double_backward_matches_conv1d(k):
    """R1's case: a gradient taken with ``create_graph`` through the
    Function, squared and differentiated again, against the same through
    ``F.conv1d``; and torch's gradgradcheck of the Function."""
    x, w, b = _conv_inputs(50 + k, 2, 3, 20, 4, k, torch.float64)
    w, b = w.requires_grad_(), b.requires_grad_()
    w2 = t(randn(60 + k, 2, 4, 3, scale=0.3)).double().requires_grad_()

    def r1(conv):
        xr = x.clone().requires_grad_()
        h = torch.nn.functional.leaky_relu(conv(xr, w, b), 0.2)
        score = conv(h, w2, None).sum()
        (g,) = torch.autograd.grad(score, xr, create_graph=True)
        return torch.autograd.grad(g.square().sum() + score, (w, b, w2))

    for h, r in zip(r1(cs_mod.ConvSame.apply), r1(_padded_conv)):
        torch.testing.assert_close(h, r, rtol=1e-10, atol=1e-12)
    small = _conv_inputs(70, 1, 2, 7, 3, 3, torch.float64)
    assert torch.autograd.gradgradcheck(
        cs_mod.ConvSame.apply, tuple(a.requires_grad_() for a in small))


def test_conv_same_computes_only_the_gradients_it_needs(monkeypatch):
    """With the weights frozen (the generator's step) the backward takes no
    weight gradient; without a gradient to x it takes no input gradient."""
    def forbidden(name):
        def f(*a, **k):
            raise AssertionError(f"{name} computed, and nobody needs it")
        return f

    x, w, b = _conv_inputs(80, 2, 3, 12, 4, 5)
    with monkeypatch.context() as m:
        m.setattr(torch.nn.grad, "conv1d_weight", forbidden("dw"))
        xg = x.clone().requires_grad_()
        cs_mod.ConvSame.apply(xg, w, b).sum().backward()
        torch.testing.assert_close(
            xg.grad, cs_mod.conv1d_same_input_grad_plain(
                torch.ones(2, 4, 12), w))
    with monkeypatch.context() as m:
        m.setattr(cs_mod, "flipped", forbidden("dx"))
        wg = w.clone().requires_grad_()
        cs_mod.ConvSame.apply(x, wg, None).sum().backward()
        assert wg.grad is not None


def _ssm_inputs(seed, B=1, T=9, H=2, d=3, e=4):
    return (randn(seed, B, T, H * e), -abs(randn(seed + 1, H, d)),
            randn(seed + 2, H, d), randn(seed + 3, H, d, e))


def test_k4_k5_do_not_fall_back_and_refuse_gradients(monkeypatch):
    """K4 and K5 on a CUDA tensor: a missing library raises, the plain
    version does not run in the kernel's place, and a call that would need
    a gradient (the kernels are forward-only) raises before any launch."""
    def no_library(name):
        raise build.KernelCompileError(f"no {name} library")

    def forbidden(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(build, "load", no_library)
    monkeypatch.setattr(rb_mod, "film_resblock_plain", forbidden)
    monkeypatch.setattr(s4_mod, "scan_dw_conv", forbidden)
    cuda = lambda a: torch.Tensor._make_subclass(_CudaLooking, t(a))
    with pytest.raises(build.KernelCompileError):
        film_resblock(*map(cuda, _block_inputs(3, 1, 9, 4)), 3)
    with pytest.raises(build.KernelCompileError):
        s4_scan(*map(cuda, _ssm_inputs(4)))
    grad = lambda a: torch.Tensor._make_subclass(_CudaLooking, t(a), True)
    x, *rest = _block_inputs(5, 1, 9, 4)
    with pytest.raises(RuntimeError, match="forward-only"):
        film_resblock(grad(x), *map(cuda, rest), 3)
    u, *rest = _ssm_inputs(6)
    with pytest.raises(RuntimeError, match="forward-only"):
        s4_scan(grad(u), *map(cuda, rest))
    with torch.no_grad(), pytest.raises(build.KernelCompileError):
        s4_scan(grad(u), *map(cuda, rest))
    assert film_resblock.launches == 0 and s4_scan.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_nvcc_candidates",
                        lambda: [str(tmp_path / "missing-nvcc")])
    with pytest.raises(build.KernelCompileError, match="nvcc not found"):
        build.build_all()


def test_ctypes_signatures_cover_every_source():
    """Every csrc/*.cu has declared entry points with pointer-sized
    arguments for pointers and the stream (ctypes would cut an int)."""
    names = {p.stem for p in build.CSRC.glob("*.cu")}
    assert names == set(build.SIGNATURES)
    for fns in build.SIGNATURES.values():
        for argtypes in fns.values():
            assert argtypes[-1] is ctypes.c_void_p
