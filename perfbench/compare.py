"""The training cell's comparison with the reference, and its FLOP count.

Numbers compared (each the worst over what it covers):

* ``loss_gap``: each checked step's acoustic, refiner, discriminator and
  generator loss, |program - reference| / |reference|;
* ``grad_gap``: each leaf's first gradient norm (from AdamW's first
  moment after the optimizer's first update), the gap of the two norms
  over the larger of the reference's norm of that leaf and of the median
  leaf (over every trained module's leaves);
* ``change_gap``: each leaf's change over the checked steps, the gap of
  the two norms over the larger of the reference's change of that leaf
  and of the median leaf, leaving out the leaves whose reference
  gradient is under a thousandth of the median leaf's (moved by
  round-off alone under Adam: the GST's, about 1e-7 against a median of
  2e-3, on every seed read);
* ``k3_gap``: each K3 launch of the checked steps, max |K3 - the float64
  log-mel of its own input|.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from perfbench.weights import draw_weights

MODULES = ("acoustic", "refiner", "vocoder.gen", "vocoder.gst",
           "vocoder.mpd", "vocoder.msd", "vocoder.mbd")
GRAD_FLOOR = 1e-3
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def module_seed(seed: int, name: str) -> int:
    """The seed of one trained module's weights."""
    return (seed * 1_000_003 + MODULES.index(name)) % (1 << 63)


def change_norms(before: Dict[str, Dict[str, torch.Tensor]],
                 after: Dict[str, Dict[str, torch.Tensor]]):
    return {m: {k: float(torch.linalg.vector_norm(after[m][k] - v))
                for k, v in leaves.items()} for m, leaves in before.items()}


def reference_train(config: dict, seed: int, draws, steps, device,
                    tf32: bool = False) -> dict:
    """The reference's checked steps from the benchmark's weights for
    ``seed``, on the program's batches and draws; with ``tf32`` its
    products in TF32 (the control)."""
    from perfbench.reference.train.engine import run_steps
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return run_steps(
            config, lambda name, mod: draw_weights(
                mod, module_seed(seed, name), device),
            draws, steps, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


def median_leaf(norms: Dict[str, Dict[str, float]]) -> float:
    """The median leaf's norm over every trained module's leaves."""
    values = [v for leaves in norms.values() for v in leaves.values()]
    return statistics.median(values) if values else 0.0


def _leaf_gaps(got: Dict[str, Dict[str, float]],
               ref: Dict[str, Dict[str, float]], keep=None):
    """(the worst leaf's gap, where: module, leaf, program, reference)."""
    worst, where = 0.0, None
    med = median_leaf(ref)
    for m, leaves in ref.items():
        if m not in got:
            return math.inf, (m, None, None, None)
        for k, r in leaves.items():
            if keep is not None and not keep(m, k):
                continue
            if k not in got[m]:
                return math.inf, (m, k, None, r)
            den = max(abs(r), med)
            if den == 0.0:
                continue
            gap = abs(got[m][k] - r) / den
            if gap > worst:
                worst, where = gap, (m, k, got[m][k], r)
    return worst, where


def control_k3(pairs, audio: dict):
    """The control's K3 outputs: the log-mel of each input in float32."""
    from perfbench.reference.mel import log_mel_f64
    return [(wav, log_mel_f64(wav, audio, torch.float32)) for wav, _ in pairs]


def train_gaps(got: dict, ref: dict, audio: dict, where: dict = None
               ) -> Dict[str, float]:
    """The four gaps; ``where``, if given, gets the worst leaf of each."""
    from perfbench.reference.mel import log_mel_f64
    loss = 0.0
    if len(got["losses"]) != len(ref["losses"]):
        loss = math.inf
    for g, r in zip(got["losses"], ref["losses"]):
        if set(g) != set(r):
            loss = math.inf
        for k in r:
            if k in g:
                loss = max(loss, abs(g[k] - r[k]) / max(abs(r[k]), 1e-12))
    grad, at_grad = _leaf_gaps(got["first_grad"], ref["first_grad"])
    floor = GRAD_FLOOR * median_leaf(ref["first_grad"])

    def moved(m, k):
        return ref["first_grad"].get(m, {}).get(k, 0.0) >= floor
    change, at_change = _leaf_gaps(got["change"], ref["change"], keep=moved)
    if where is not None:
        where.update(grad=at_grad, change=at_change)
    k3 = 0.0 if got["k3"] else math.inf
    for wav, out in got["k3"]:
        k3 = max(k3, float((out.double() - log_mel_f64(wav, audio)).abs()
                           .max()))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "k3_gap": k3}


def mel_nnz(audio: dict) -> int:
    import numpy as np
    from perfbench.reference.dsp.stft import mel_filterbank
    return int(np.count_nonzero(mel_filterbank(
        audio["sample_rate"], audio["n_fft"], audio["n_mels"],
        audio["f_min"], audio["f_max"])))


class FlopCount(TorchDispatchMode):
    """The FLOPs of every operator ``torch.utils.flop_counter`` has a
    formula for (matmuls, convolutions, attention) run inside it, forward
    and backward, double backward included (``FlopCounterMode`` tracks
    modules and cannot run under ``autograd.grad``)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is None:
            # an operator left whole (``linear`` under inference mode):
            # its decomposition comes back through this mode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


class MetaDraws:
    """Draws of the right shapes on the meta device, for counting."""

    def uniform(self, shape, low=0.0, high=1.0):
        return torch.empty(tuple(shape), device="meta")

    normal = uniform

    def randint(self, shape, low, high):
        return torch.empty(tuple(shape), device="meta", dtype=torch.long)

    def bernoulli(self, p, shape):
        return torch.empty(tuple(shape), device="meta", dtype=torch.bool)

    def mark(self):
        return None

    def rewind(self, mark):
        pass


def window_flops(config: dict, steps: List[dict]) -> float:
    """The matmul, convolution and attention FLOPs (forward and backward)
    of the window's engine steps, counted by ``FlopCount`` over the
    reference's blocks on the meta device at each step's shapes: the
    acoustic block on its micro-batches, the refiner when it updated, each
    discriminator step (with R1 or without) and the generator step."""
    from perfbench.reference.train.engine import build
    with torch.device("meta"):
        blocks = build(config, "meta")
    for b in ("acoustic", "refiner"):
        blocks[b].state.draws = MetaDraws()
    voc = blocks["vocoder"]
    voc.states["gen"].draws = MetaDraws()
    cache: Dict[tuple, float] = {}

    def count(key, fn):
        if key not in cache:
            with FlopCount() as fc:
                fn()
            cache[key] = float(fc.total)
        return cache[key]

    total = 0.0
    for s in steps:
        micro = [{k: torch.empty(shape, dtype=_DTYPES[dt], device="meta")
                  for k, (shape, dt) in m.items()} for m in s["micro"]]
        sig = tuple(tuple(sorted((k, tuple(v[0])) for k, v in m.items()))
                    for m in s["micro"])
        acc = blocks["acoustic"]
        total += count(("acoustic", sig),
                       lambda: acc.train_step_accum(micro) if len(micro) > 1
                       else acc.train_step(micro[0]))
        mel = micro[0]["mel"]
        if s["refiner"]:
            total += count(("refiner", sig[0]), lambda: blocks[
                "refiner"].train_step(micro[0], mel, 1.0, 1.0))
        for r1 in s["r1"]:
            def disc(r1=r1):
                voc.states["mpd"].step = 0 if r1 else 1
                voc.disc_step(micro[0])
            total += count(("disc", sig[0], r1), disc)
        if s["r1"]:
            total += count(("gen", sig[0]), lambda: voc.gen_step(micro[0]))
    return total
