"""The engine's first steps, step by step as ``ttsx_torch/train/engine.py``
takes them, on the reference's blocks.

``run_steps`` builds the acoustic, refiner and vocoder blocks of the
configuration, loads the given weights, resets the generator's EMA to
them, replays the given draws and takes one engine step per list of
micro-batches: the acoustic block on every micro-batch (one update from
their mean gradient), the refiner on the first micro-batch every
``refiner_update_freq`` steps, then the vocoder's discriminator steps
(as many as the loss EMAs ask for under ``dynamic_gan``) and its
generator step on the first micro-batch. No validation runs, so the
noise scale and the L1 weight stay 1.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from perfbench.reference.core.config import TTSXConfig, from_dict
from perfbench.reference.nn.draws import ReplayDraws
from perfbench.reference.train.blocks import (AcousticBlock, RefinerBlock,
                                              VocoderBlock)


def modules(blocks: Dict) -> Dict[str, torch.nn.Module]:
    """Every trained module by the name the comparison gives it."""
    voc = blocks["vocoder"]
    return {"acoustic": blocks["acoustic"].model,
            "refiner": blocks["refiner"].model,
            **{f"vocoder.{n}": voc.states[n].module for n in voc.PARTS}}


def states(blocks: Dict) -> Dict[str, object]:
    voc = blocks["vocoder"]
    return {"acoustic": blocks["acoustic"].state,
            "refiner": blocks["refiner"].state,
            **{f"vocoder.{n}": voc.states[n] for n in voc.PARTS}}


def build(config: dict, device) -> Dict:
    cfg = from_dict(TTSXConfig, config)
    return {"acoustic": AcousticBlock(cfg, device),
            "refiner": RefinerBlock(cfg, device),
            "vocoder": VocoderBlock(cfg, device)}


class InOrderDraws(ReplayDraws):
    """Recorded draws handed back in the order they were made: the
    recording holds each micro-batch's own draws, so a rewind reads on."""

    def rewind(self, mark) -> None:
        pass


def run_steps(config: dict, weights: Callable, draws: Dict[str, list],
              steps: List[List[dict]], device) -> dict:
    """``weights(name, module)``: the tensors to load into each module, by
    name; ``draws``: "acoustic", "refiner", "vocoder" -> recorded draws;
    ``steps``: the micro-batches of each engine step. Returns each step's
    losses, each leaf's first gradient norm (the gradient each
    optimizer's first update took) and each leaf's change over the
    steps, each by module name and parameter name."""
    blocks = build(config, device)
    cfg = blocks["acoustic"].cfg.train
    mods = modules(blocks)
    with torch.no_grad():
        for name, mod in mods.items():
            own = dict(mod.named_parameters())
            own.update(mod.named_buffers())
            for k, v in weights(name, mod).items():
                own[k].copy_(v)
    start = {name: {k: p.detach().clone() for k, p in mod.named_parameters()}
             for name, mod in mods.items()}
    blocks["vocoder"].states["gen"].reset_ema()
    blocks["acoustic"].state.draws = InOrderDraws(draws["acoustic"], device)
    blocks["refiner"].state.draws = InOrderDraws(draws["refiner"], device)
    blocks["vocoder"].states["gen"].draws = InOrderDraws(draws["vocoder"],
                                                         device)
    first = {}
    for name, st in states(blocks).items():
        first_grad_hook(st, name, first)
    d_ema = g_ema = 1.0
    out = []
    for step, micro in enumerate(steps):
        m = {}
        a = blocks["acoustic"].train_step_accum(micro) \
            if cfg.grad_accum_steps > 1 else \
            blocks["acoustic"].train_step(micro[0])
        m["acoustic/loss"] = float(a["metrics"]["loss"])
        mel_pred = a["mel_pred"][0] if isinstance(a["mel_pred"], list) \
            else a["mel_pred"]
        if step % cfg.refiner_update_freq == 0:
            r = blocks["refiner"].train_step(micro[0], mel_pred, 1.0, 1.0)
            m["refiner/loss"] = float(r["metrics"]["loss"])
        if step >= cfg.vocoder_freeze_until and "wav" in micro[0]:
            voc = blocks["vocoder"]
            d_steps = cfg.gan_d_steps
            if cfg.novel.dynamic_gan:
                ratio = d_ema / max(g_ema, 1e-6)
                if ratio > 1.5:
                    d_steps = min(cfg.gan_d_steps + 1, 3)
                elif ratio < 0.5:
                    d_steps = max(cfg.gan_d_steps - 1, 1)
            for _ in range(d_steps):
                dm = voc.disc_step(micro[0])
            gm = voc.gen_step(micro[0])
            d_l, g_l = float(dm["d_loss"]), float(gm["g_loss"])
            d_ema = 0.9 * d_ema + 0.1 * d_l
            g_ema = 0.9 * g_ema + 0.1 * g_l
            m.update({"vocoder/d_loss": d_l, "vocoder/g_loss": g_l})
        out.append(m)
    change = {name: {k: float(torch.linalg.vector_norm(p.detach()
                                                       - start[name][k]))
                     for k, p in mod.named_parameters()}
              for name, mod in mods.items()}
    return {"losses": out, "first_grad": first, "change": change}


def first_grad_hook(state, name: str, into: Dict[str, Dict[str, float]]):
    """Wrap ``state.tx.step`` so that after the optimizer's first update
    ``into[name]`` holds each leaf's first gradient norm, read back from
    AdamW's first moment (exp_avg = (1 - beta1) g after one update)."""
    tx = state.tx
    step = tx.step

    def wrapped():
        lr = step()
        if name not in into:
            beta1 = tx.adamw.param_groups[0]["betas"][0]
            into[name] = first_grad_norms(state.module, tx, beta1)
        return lr
    tx.step = wrapped


@torch.no_grad()
def first_grad_norms(module, tx, beta1: float) -> Dict[str, float]:
    st = tx.adamw.state
    return {k: float(torch.linalg.vector_norm(st[p]["exp_avg"])) / (1 - beta1)
            for k, p in module.named_parameters() if p in st}
