"""Random weights from the seed, drawn on the device in a few large calls.

``draw_weights(model, seed, device)`` gives every parameter (and the VQ
statistics, the only drawn buffers) a value from one normal draw of the
whole model's size, made by a ``torch.Generator`` on ``device``, and cut
by name in ``named_modules()`` order. The scale of each tensor follows
the kind of layer, as the port's fresh initializer does, except that
nothing is left at zero or at one: FiLM projections, attention gains,
layer scales, biases and norm affines all get small random values, so
that every path a kernel implements (a FiLM's scale and shift, a bias, a
residual gain) carries a signal the comparison can see.

The same names and shapes in the program and in the reference give the
same tensors: both load what this returns.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

_LEAF_OFFSETS = ("bias", "experts_b", "C0", "pos_bias")


def _kinds(m: nn.Module) -> set:
    return {c.__name__ for c in type(m).__mro__}


def _fan_in(m: nn.Module, kinds: set, name: str, t: torch.Tensor):
    """1 / sqrt(fan_in) for a layer's kernel, as lecun normal; None for a
    tensor that is not a kernel."""
    if name != "weight" and not (name == "experts_w" and "GumbelMoE" in kinds):
        return None
    if "GumbelMoE" in kinds:
        return t.shape[0] * t.shape[1]
    if "Embedding" in kinds or "LayerNorm" in kinds or "GroupNorm" in kinds:
        return None
    if "Linear" in kinds:
        return m.in_features
    if "SNConv" in kinds:
        return t[0].numel()
    if "ConvTranspose1d" in kinds:
        return t.shape[0] * t.shape[2]
    if "Conv1d" in kinds:
        return t.shape[1] * t.shape[2]
    return None


def plan(model: nn.Module) -> List[Tuple[str, float, float]]:
    """(name, mean, std) of every tensor to draw, in draw order."""
    out = []
    for mname, m in model.named_modules():
        kinds = _kinds(m)
        own = dict(m.named_parameters(recurse=False))
        if "VectorQuantizer" in kinds:
            own["embed_sum"] = m.embed_sum
            own["cluster_size"] = m.cluster_size
        for name, t in own.items():
            full = f"{mname}.{name}" if mname else name
            fan = _fan_in(m, kinds, name, t)
            if fan is not None:
                std = 1.0 / math.sqrt(fan)
                if getattr(m, "zero_init", False):
                    std *= 0.1
                out.append((full, 0.0, std))
            elif name == "weight" and "Embedding" in kinds:
                out.append((full, 0.0, t.shape[1] ** -0.5))
            elif name in ("weight", "g") and kinds & {"LayerNorm", "GroupNorm",
                                                      "ScaleNorm"}:
                out.append((full, 1.0, 0.05))
            elif name in _LEAF_OFFSETS:
                out.append((full, 0.0, 0.02))
            elif name in ("C1", "C2"):
                out.append((full, 0.0, 0.02))
            elif name in ("U", "V"):
                out.append((full, 0.0, m.d ** -0.5))
            elif name == "gamma":
                out.append((full, 0.1, 0.02))
            elif name == "intensity":
                out.append((full, 1.0, 0.05))
            elif name == "cluster_size":
                out.append((full, 1.0, 0.0))
            else:   # GST tokens, VQ embed_sum, anything else: unit normal
                out.append((full, 0.0, 1.0))
    return out


@torch.no_grad()
def draw_weights(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor on ``device``} for every tensor ``plan`` lists: one
    normal draw of the total size, clipped at two standard deviations,
    scaled and shifted per tensor."""
    shapes = dict(model.named_parameters())
    shapes.update(model.named_buffers())
    entries = plan(model)
    sizes = [shapes[n].numel() for n, _, _ in entries]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.clamp_(-2.0, 2.0)
    out = {}
    for (name, mean, std), part in zip(entries, flat.split(sizes)):
        out[name] = (part.view(shapes[name].shape) * std + mean).to(
            shapes[name].dtype)
    return out


@torch.no_grad()
def load_weights(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's tensors of the same names, in
    place (an optimizer holding the parameters keeps them)."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    missing = [n for n in weights if n not in own]
    if missing:
        raise KeyError(f"no tensor named {missing[:3]} in the model")
    for name, value in weights.items():
        own[name].copy_(value)
