"""A fresh start with flax's default initializers, drawn from one
``torch.Generator``.

The port's modules are built to be filled from a flax tree; a trainer
that starts from nothing calls ``fresh_init_`` instead, which gives every
parameter the distribution the reference's ``init`` gives it:

* Dense, attention projections, convs, ConvTranspose, MoE experts:
  lecun normal (truncated at two standard deviations, std
  sqrt(1 / fan_in) / 0.8796), biases zero; a ``zero_init`` conv kernel 0;
* LayerNorm / GroupNorm / ScaleNorm scales 1, offsets 0;
* Embed N(0, 1 / features);
* S4: C1, C2 N(0, 0.02^2), U, V N(0, 1/d), C0 and ``pos_bias`` zero;
* layer scale ``ls_init``, emotion intensity 1, attention gain 0;
* VQ statistics: ``embed_sum`` N(0, 1), ``cluster_size`` 1.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ttsx_torch.nn.attention import SelfAttention1d
from ttsx_torch.nn.conv import Conv1d, ConvTranspose1d
from ttsx_torch.nn.film import ResidualConvBlock, ScaleNorm
from ttsx_torch.nn.gst import GlobalStyleTokens
from ttsx_torch.nn.layers import GroupNorm
from ttsx_torch.nn.moe import GumbelMoE
from ttsx_torch.nn.s4 import S4
from ttsx_torch.nn.vq import VectorQuantizer

_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]


def _normal(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=gen) * std)


def _lecun(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(t.shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    t.copy_(w * std)


def _own(m: nn.Module, name: str):
    return dict(m.named_parameters(recurse=False)).get(
        name, dict(m.named_buffers(recurse=False)).get(name))


@torch.no_grad()
def fresh_init_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Re-draw every parameter and buffer of ``model`` in place; returns it.

    Modules are visited in ``model.modules()`` order, so one seed gives one
    model wherever it runs (the draws are made on the CPU)."""
    for m in model.modules():
        for name in ("bias", "experts_b", "C0", "pos_bias"):
            p = _own(m, name)
            if p is not None and not isinstance(m, (nn.LayerNorm, GroupNorm)):
                p.zero_()
        if isinstance(m, nn.Linear):
            _lecun(m.weight, m.in_features, gen)
        elif isinstance(m, Conv1d):
            if m.zero_init:
                m.weight.zero_()
            else:
                _lecun(m.weight, m.weight.shape[1] * m.weight.shape[2], gen)
        elif isinstance(m, ConvTranspose1d):
            _lecun(m.weight, m.weight.shape[0] * m.weight.shape[2], gen)
        elif isinstance(m, (nn.LayerNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, ScaleNorm):
            m.g.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            _normal(m.weight, m.weight.shape[1] ** -0.5, gen)
        elif isinstance(m, GumbelMoE):
            e, d_in, _ = m.experts_w.shape
            _lecun(m.experts_w, e * d_in, gen)
        elif isinstance(m, S4):
            _normal(m.C1, 0.02, gen)
            _normal(m.C2, 0.02, gen)
            _normal(m.U, m.d ** -0.5, gen)
            _normal(m.V, m.d ** -0.5, gen)
        elif isinstance(m, ResidualConvBlock):
            m.gamma.fill_(m.ls_init)
        elif isinstance(m, SelfAttention1d):
            m.gamma.zero_()
        elif isinstance(m, GlobalStyleTokens):
            _normal(m.tokens, 1.0, gen)
        elif isinstance(m, VectorQuantizer):
            _normal(m.embed_sum, 1.0, gen)
            m.cluster_size.fill_(1.0)
        intensity = _own(m, "intensity")
        if intensity is not None:
            intensity.fill_(1.0)
    return model
