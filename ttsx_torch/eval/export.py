"""Model export (``ttsx/eval/export.py``) as ``torch.export`` programs.

The reference serializes StableHLO (``jax.export``), which has no torch
counterpart. The port writes a ``torch.export`` program instead: the
module traced at example inputs into an ``ExportedProgram``, saved as a
``.pt2`` file (graph and weights), which ``torch.export.load(...).module()``
runs without the model's Python code.
"""
from __future__ import annotations

import io
from pathlib import Path
from typing import Callable, Sequence

import torch


def export_pt2(module: torch.nn.Module, args: Sequence[torch.Tensor],
               path: str | Path) -> bytes:
    """``torch.export`` of ``module`` at the example ``args``, saved to
    ``path``; returns the file's bytes. Replaces the reference's
    ``export_stablehlo``."""
    program = torch.export.export(module, tuple(args))
    torch.export.save(program, str(path))
    return Path(path).read_bytes()


def load_pt2(path: str | Path) -> Callable:
    """The program saved by ``export_pt2``, as a callable module. Replaces
    the reference's ``load_stablehlo``."""
    return torch.export.load(str(path)).module()


def aot_compile(module: torch.nn.Module, args: Sequence[torch.Tensor]
                ) -> Callable:
    """``module`` exported at ``args``, serialized, reloaded and called
    once at ``args`` (no gradient); returns the reloaded program. Replaces
    the reference's ``aot_compile``, whose executable is compiled before
    its first call: here the program is traced and checked to run before
    it serves."""
    buf = io.BytesIO()
    torch.export.save(torch.export.export(module, tuple(args)), buf)
    buf.seek(0)
    program = torch.export.load(buf).module()
    with torch.no_grad():
        program(*args)
    return program


def example_mel(cfg, device) -> torch.Tensor:
    """The speaker encoder's example input: 2 s of zero mel [1, 172,
    n_mels] at the default audio config."""
    frames = int(2.0 * cfg.audio.sample_rate / cfg.audio.hop_length)
    return torch.zeros(1, frames, cfg.audio.n_mels, device=device)


def export_reference_encoder(model: torch.nn.Module,
                             path: str | Path =
                             "reference_encoder_exported.pt2") -> bytes:
    """``export_pt2`` of a ``ReferenceEncoder`` (in eval mode, on its own
    device) at ``example_mel``. Replaces the reference's
    ``export_reference_encoder``."""
    device = next(model.parameters()).device
    return export_pt2(model.eval(), (example_mel(model.cfg, device),), path)
