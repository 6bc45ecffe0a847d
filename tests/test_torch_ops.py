"""The port's kernels K1 (ConvT upsample) and K2 (FiLM resblock stack).

On the CPU: each kernel's plain PyTorch version against the Pallas TPU
kernel it replaces, run in interpret mode as tests/test_ops.py runs it;
the wrappers' device dispatch (a CPU tensor runs the plain version,
anything else launches the kernel or raises — never a quiet fallback).
The CUDA kernels themselves are checked on the card by
tests/test_torch_gpu.py.
"""
import ctypes

import jax.numpy as jnp
import pytest
import torch

from torch_parity_helpers import close, randn, t

from ttsx_torch.ops import build, convt_upsample, film_resblock_stack
from ttsx_torch.ops.resblock_stack import film_resblock_stack_plain
import ttsx_torch.ops.resblock_stack as rs_mod
import ttsx_torch.ops.upsample as up_mod

# f32 sums in other orders: 1e-5 relative / 1e-5 absolute for K1's two
# products per row; K2 chains 6 convs, so 1e-4 / 1e-4 as test_ops.py does
K1_TOL = dict(rtol=1e-5, atol=1e-5)
K2_TOL = dict(rtol=1e-4, atol=1e-4)


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


def test_wrappers_raise_off_cpu_and_cuda():
    x = torch.empty(1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        convt_upsample(x, torch.empty(4, 4, 4, device="meta"),
                 torch.empty(4, device="meta"), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        film_resblock_stack(x, torch.empty(1, 4, 24, device="meta"),
                       *(torch.empty(1, device="meta"),) * 4, (1, 3, 5))


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
    cuda = lambda a: torch.Tensor._make_subclass(_CudaLooking, t(a))
    with pytest.raises(build.KernelCompileError):
        convt_upsample(cuda(randn(0, 1, 5, 8)), cuda(randn(1, 4, 8, 4)),
                 cuda(randn(2, 4)), 2)
    with pytest.raises(build.KernelCompileError):
        film_resblock_stack(*map(cuda, _stack_inputs(3, 1, 9, 4, 9)), (1, 3, 5))
    assert convt_upsample.launches == 0 and film_resblock_stack.launches == 0


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
