"""A block's train state (``ttsx/train/state.py``): the module, its
optimizer, the update count, the block's random draws and, with
``ema_decay > 0``, an EMA copy of the parameters.

PyTorch keeps parameters in the module, so ``apply_gradients`` reads the
parameters' ``.grad``, steps them in place and clears the gradients.
Buffers (the refiner's VQ statistics) are never stepped. After each
update the EMA becomes ``d * ema + (1 - d) * params`` of the *new*
parameters, as the reference's does. Only the vocoder's generator keeps
one (``VocoderConfig.ema_decay``); the acoustic and refiner blocks run
without, so they validate on the module itself.

Under an active mesh (``ttsx_torch.core.mesh``) ``apply_gradients``
first averages the gradients over every rank, in one all-reduce, so the
optimizer's clip sees the global norm as in the reference's sharded
program. Every rank's loss is a mean over its rows with global
denominators, so the average is the global batch's gradient; under the
generator's ``band_tp`` the tp gather's backward hands each rank tp x
its bands' gradient, so the average is right there too. The reduction
reads ``.grad`` after the backward, so R1's double backward needs no
``DistributedDataParallel`` (whose reducer does not serve
``create_graph``), and the refiner's VQ buffers are never broadcast
(``broadcast_buffers`` would overwrite the other ranks' statistics).

``state_dict`` / ``load_state_dict`` hold everything the reference's
``TrainState`` pytree holds, as tensors: the update ``step``, the
module's parameters and buffers (``params``), the optimizer's ``count``
and Adam moments (``opt``: ``exp_avg`` and ``exp_avg_sq`` of every
parameter, zeros before the first update, which is what AdamW starts
from), the ``ema`` when one is kept, and the state of the
``torch.Generator`` behind ``draws`` (``rng``). Loading them into a
state built the same way continues the run bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ttsx_torch.core.mesh import active_mesh
from ttsx_torch.nn.draws import Draws
from ttsx_torch.train.optim import ClippedAdamW
from ttsx_torch.utils.spans import span


class TrainState:
    def __init__(self, module: nn.Module, tx: ClippedAdamW, draws: Draws,
                 ema_decay: float = 0.0):
        self.module = module
        self.tx = tx
        self.draws = draws
        self.step = 0
        self.ema_decay = ema_decay
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if ema_decay > 0:
            self.reset_ema()

    def reset_ema(self) -> None:
        """Start the EMA at the module's current parameters."""
        self.ema = {n: p.detach().clone()
                    for n, p in self.module.named_parameters()}

    @torch.no_grad()
    def apply_gradients(self) -> float:
        """One optimizer update, inside an ``optim.update`` span (its
        attribute ``module`` the module's class name); returns the rate
        it used."""
        with span("optim.update", module=type(self.module).__name__):
            average_gradients(self.module)
            lr = self.tx.step()
            self.module.zero_grad(set_to_none=True)
            self.step += 1
            if self.ema is not None:
                d = self.ema_decay
                for n, p in self.module.named_parameters():
                    e = self.ema[n]
                    e.copy_(d * e + (1.0 - d) * p)
        return lr

    def state_dict(self) -> Dict[str, object]:
        """The state as a nested dict of tensors (live views: copy to keep)."""
        adamw = self.tx.adamw
        opt = {"count": torch.tensor(self.tx.count), "exp_avg": {},
               "exp_avg_sq": {}}
        for n, p in self.module.named_parameters():
            st = adamw.state.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                opt[k][n] = st[k] if k in st else torch.zeros_like(p)
        out = {"step": torch.tensor(self.step),
               "params": dict(self.module.state_dict()), "opt": opt}
        if self.ema is not None:
            out["ema"] = dict(self.ema)
        gen = getattr(self.draws, "gen", None)
        if gen is not None:
            out["rng"] = gen.get_state()
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Take a ``state_dict`` of a state built the same way (the
        checkpoint module has checked its keys and shapes)."""
        self.module.load_state_dict(state["params"], strict=True)
        self.step = int(state["step"])
        opt = state["opt"]
        self.tx.count = int(opt["count"])
        adamw = self.tx.adamw
        for n, p in self.module.named_parameters():
            # AdamW's own step counter, a CPU float tensor, is the count
            adamw.state[p] = {
                "step": torch.tensor(float(self.tx.count)),
                "exp_avg": opt["exp_avg"][n].to(p.device).clone(),
                "exp_avg_sq": opt["exp_avg_sq"][n].to(p.device).clone()}
        if self.ema is not None:
            for n, e in self.ema.items():
                e.copy_(state["ema"][n])
        if "rng" in state:
            self.draws.gen.set_state(state["rng"])

    def eval_params(self, use_ema: bool = True) -> Dict[str, torch.Tensor]:
        """The module's state dict with the EMA in place of the parameters
        when ``use_ema`` and an EMA is kept (the reference's
        ``eval_params``); load it into a copy of the module to run it."""
        state = dict(self.module.state_dict())
        if use_ema and self.ema is not None:
            state.update(self.ema)
        return state


@torch.no_grad()
def average_gradients(module: nn.Module) -> None:
    """Under an active mesh of more than one rank, every parameter's
    ``.grad`` becomes its mean over the ranks (one all-reduce of the
    gradients flattened together; every rank holds the same set)."""
    mesh = active_mesh()
    if mesh is None or mesh.size == 1:
        return
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    flat /= mesh.size
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))
