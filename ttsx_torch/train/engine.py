"""The unified trainer (``ttsx/train/engine.py``): acoustic, refiner and
vocoder blocks, all three by default, as in the reference.

Each engine step trains the acoustic block on ``grad_accum_steps``
micro-batches (one update from their mean gradient), then, every
``refiner_update_freq`` steps, the refiner on the step's first
micro-batch and the acoustic prediction for it, then, from
``vocoder_freeze_until`` on and when the batch carries ``"wav"``, the
vocoder GAN on the step's first micro-batch: ``_dynamic_d_steps()``
discriminator steps and one generator step. With ``dynamic_gan`` the
ratio of the loss EMAs (d / g, both from 1.0, a = 0.9) adds a
discriminator step above 1.5 (at most 3) and takes one away below 0.5
(at least 1); otherwise ``gan_d_steps``. ``validate`` runs the acoustic
and refiner blocks without draws (a run without either returns ``{}``,
as the reference's); with ``sde_noise_annealing`` the refiner's noise
scale and L1 weight follow the validation L1. ``ema_swap_validate`` has
nothing to swap: only the vocoder's generator keeps an EMA, and the
vocoder is not validated.

Checkpoints (``ttsx_torch.train.checkpoint``, with ``checkpoint_dir``):
``train()`` saves ``best`` after a validation that improves
``best_val``, ``last`` every ``checkpoint_freq`` steps and ``final`` at
the end, calling each callback's ``on_checkpoint`` after each save, as
the reference's does. A checkpoint holds every block's
``state_dict`` (parameters and buffers, optimizer moments and counts,
update steps, the generator's EMA, each block's generator state) and,
in ``extra``, ``best_val``, ``noise_scale``, ``l1_weight``, the
dynamic-GAN loss EMAs and ``batches``, the number of batches the run's
steps took from the stream (micro-batches included).
``restore_checkpoint`` loads it into the trainer's blocks, which exist
from construction on, so the run goes on bit for bit from the step it
was saved at; the caller feeds the batches that follow, from
``batches`` on (``cli.main.main_train``).

Five departures from the reference, the first two reference defects:

* micro-batches of different bucket lengths train (the reference stacks
  them with ``jnp.stack``, which raises);
* under accumulation the refiner gets micro-batch 0's own ``mel_pred``
  (the reference pairs micro-batch 0 with the last micro-batch's);
* a GAN step that runs out of device memory (``torch.OutOfMemoryError``,
  nothing else) is skipped and counted in ``oom_count``, as in the
  reference, but the discriminator updates it made before the failure
  stay: the port updates in place, where the reference's functional
  states drop them with the step;
* ``extra`` also holds ``d_loss_ema`` and ``g_loss_ema``, so a resumed
  run keeps its discriminator:generator ratio (the reference's starts it
  again from 1.0 and drifts from an uninterrupted run);
* a checkpoint can be restored before the first ``train_step`` (the
  reference's ``main_train --resume`` restores into the empty state
  tree of a trainer that has not yet built its states, which raises).

Each engine step is a ``train.step`` span (``ttsx_torch.utils.spans``;
its id ``state.global_step``), whose duration is the step's
``step_time_s`` (and ``state.step_times``), around ``train.place``,
``train.next_batch`` (the later micro-batches pulled from the stream),
``train.acoustic``, ``train.refiner``, ``train.gan`` (``_gan_step``) and
``train.metrics`` (the host reads of the step's losses).

An ``observer`` (``ttsx_torch.train.observer.Observer``) transforms
each stage's batch before that stage's step, at every call site of the
reference: each acoustic micro-batch, the refiner's and the vocoder's
batch, and, with ``training=False``, the acoustic and refiner
validation batches. It sees the batch as the engine holds it, a dict of
tensors on the engine's device (``blocks.as_tensors``), and the step
number ``state.global_step``.

``mesh=`` (a ``ttsx_torch.core.mesh.Mesh`` on the engine's device) runs
the engine SPMD, one process per rank, as the reference's ``mesh=``
shards its batches: every rank builds the same blocks (their states
broadcast from rank 0 once), takes the same global batches from the same
stream and steps on its rows of the dp axis, inside ``with mesh:``, so
the blocks' draws, masked means, VQ statistics and gradient averages are
the global batch's. The metrics ``train_step`` and ``validate`` return
are their means over the ranks, the same floats on every rank, and so is
all control flow that reads them: the dynamic-GAN ratio, the
validation-driven noise scale and L1 weight, and the ``best``
checkpoint. Rank 0 alone writes checkpoints (the others wait for it);
every rank restores them. A GAN step that runs out of memory raises
under a mesh of more than one rank: one rank skipping it would leave the
others waiting in a collective.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ttsx_torch.core.config import TTSXConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.core.mesh import shard_batch
from ttsx_torch.train import checkpoint as ckpt
from ttsx_torch.train.blocks import (AcousticBlock, RefinerBlock,
                                     VocoderBlock, as_tensors)
from ttsx_torch.train.callbacks import Callback
from ttsx_torch.utils.spans import span, timed

# TrainerState fields a checkpoint's ``extra`` carries, with the values a
# checkpoint without them restores
EXTRA = {"best_val": float("inf"), "noise_scale": 1.0, "l1_weight": 1.0,
         "d_loss_ema": 1.0, "g_loss_ema": 1.0, "batches": 0}


class BlockRegistry:
    """Name -> block factory; ``create(name, cfg, device, seed)`` builds a
    registered block and raises ``KeyError`` on an unknown name."""
    _registry: Dict[str, Callable] = {}

    @classmethod
    def register(cls, name: str):
        def deco(fn):
            cls._registry[name] = fn
            return fn
        return deco

    @classmethod
    def create(cls, name: str, cfg: TTSXConfig, device="cuda",
               seed: int = 0):
        if name not in cls._registry:
            raise KeyError(f"unknown train block '{name}'")
        return cls._registry[name](cfg, device, seed)


BlockRegistry.register("acoustic")(AcousticBlock)
BlockRegistry.register("refiner")(RefinerBlock)
BlockRegistry.register("vocoder")(VocoderBlock)


class TrainerState:
    """Host-side view of the run."""

    def __init__(self):
        self.global_step = 0
        self.best_val = float("inf")
        self.noise_scale = 1.0     # sde_noise_annealing
        self.l1_weight = 1.0       # refiner L1 <-> score-matching blend
        self.d_loss_ema = 1.0      # dynamic_gan ratio
        self.g_loss_ema = 1.0
        self.oom_count = 0
        self.batches = 0           # batches the steps took from the stream
        self.step_times: List[float] = []


class UnifiedTrainer:
    """``UnifiedTrainer(cfg, train_iter, val_iter).train()``.

    Block i of ``blocks`` is seeded with ``cfg.train.seed + i``."""

    def __init__(self, cfg: TTSXConfig, train_iter: Iterable[Dict],
                 val_iter=None, callbacks: Optional[List[Callback]] = None,
                 blocks: Iterable[str] = ("acoustic", "refiner", "vocoder"),
                 checkpoint_dir: Optional[str] = None, device="cuda",
                 observer=None, mesh=None):
        self.cfg = cfg
        self.observer = observer
        self.checkpoint_dir = checkpoint_dir
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device}, the engine on "
                             f"{self.device}")
        self.train_iter = iter(train_iter)
        # a one-shot generator is kept as a list, so that every validation
        # pass sees every batch
        if (val_iter is not None and not callable(val_iter)
                and iter(val_iter) is val_iter):
            val_iter = list(val_iter)
        self.val_iter = val_iter
        self.callbacks = callbacks or []
        self.state = TrainerState()
        self.blocks = {}
        for i, name in enumerate(blocks):
            self.blocks[name] = BlockRegistry.create(name, cfg, self.device,
                                                     cfg.train.seed + i)
        if mesh is not None:
            from ttsx_torch.parallel import replicate
            for block in self.blocks.values():
                replicate(block, mesh)

    def _meshed(self):
        return self.mesh if self.mesh is not None else contextlib.nullcontext()

    def _place(self, batch: Dict) -> Dict:
        """The batch's tensors on the engine's device; under a mesh, this
        rank's rows of them."""
        with span("train.place"):
            b = as_tensors(batch, self.device)
            return b if self.mesh is None else shard_batch(b, self.mesh)

    def _global(self, metrics: Dict[str, float]) -> Dict[str, float]:
        return metrics if self.mesh is None else self.mesh.mean(metrics)

    def _pre_forward(self, stage: str, batch: Dict,
                     training: bool = True) -> Dict:
        if self.observer is None:
            return batch
        return self.observer.pre_forward(stage, batch,
                                         step=self.state.global_step,
                                         training=training)

    def train_step(self, batch: Dict) -> Dict:
        with self._meshed():
            return self._train_step(batch)

    def _train_step(self, batch: Dict) -> Dict:
        with timed("train.step", id=self.state.global_step) as step:
            metrics = self._step_blocks(batch)
        self.state.step_times.append(step.seconds)
        metrics["step_time_s"] = step.seconds
        for cb in self.callbacks:
            cb.on_step_end(self, metrics)
        return metrics

    def _step_blocks(self, batch: Dict) -> Dict:
        cfg = self.cfg.train
        metrics: Dict[str, float] = {}
        b = self._place(batch)
        mel_pred = b["mel"]
        taken = 1       # batches this step takes from the stream

        if "acoustic" in self.blocks:
            block = self.blocks["acoustic"]
            if cfg.grad_accum_steps > 1:
                micro = [self._pre_forward("acoustic", b)]
                for _ in range(cfg.grad_accum_steps - 1):
                    try:
                        with span("train.next_batch"):
                            nxt = next(self.train_iter)
                    except StopIteration:
                        break
                    micro.append(self._pre_forward("acoustic",
                                                   self._place(nxt)))
                taken = len(micro)
                with span("train.acoustic"):
                    out = block.train_step_accum(micro)
                mel_pred = out["mel_pred"][0]
            else:
                with span("train.acoustic"):
                    out = block.train_step(self._pre_forward("acoustic", b))
                mel_pred = out["mel_pred"]
            with span("train.metrics"):
                metrics.update(self._global({
                    f"acoustic/{k}": float(v)
                    for k, v in out["metrics"].items()}))

        if ("refiner" in self.blocks
                and self.state.global_step % cfg.refiner_update_freq == 0):
            with span("train.refiner"):
                out = self.blocks["refiner"].train_step(
                    self._pre_forward("refiner", b), mel_pred,
                    self.state.noise_scale, self.state.l1_weight)
            with span("train.metrics"):
                metrics.update(self._global({
                    f"refiner/{k}": float(v)
                    for k, v in out["metrics"].items()}))

        if ("vocoder" in self.blocks
                and self.state.global_step >= cfg.vocoder_freeze_until
                and "wav" in b):
            with span("train.gan"):
                metrics.update(self._gan_step(self._pre_forward("vocoder",
                                                                b)))

        self.state.global_step += 1
        self.state.batches += taken
        return metrics

    def _gan_step(self, b: Dict) -> Dict:
        voc = self.blocks["vocoder"]
        d_steps = self._dynamic_d_steps()
        try:
            for _ in range(d_steps):
                dm = voc.disc_step(b)
            gm = voc.gen_step(b)
        except torch.OutOfMemoryError:
            if self.mesh is not None and self.mesh.size > 1:
                raise
            voc.zero_grad()
            self.state.oom_count += 1
            return {"vocoder/oom": self.state.oom_count}
        with span("train.metrics"):
            losses = self._global({"d": float(dm["d_loss"]),
                                   "g": float(gm["g_loss"])})
        d_l, g_l = losses["d"], losses["g"]
        a = 0.9
        st = self.state
        st.d_loss_ema = a * st.d_loss_ema + (1 - a) * d_l
        st.g_loss_ema = a * st.g_loss_ema + (1 - a) * g_l
        return {"vocoder/d_loss": d_l, "vocoder/g_loss": g_l,
                "vocoder/d_steps": d_steps}

    def _dynamic_d_steps(self) -> int:
        """``dynamic_gan``: more discriminator steps when D lags G."""
        tr = self.cfg.train
        if not tr.novel.dynamic_gan:
            return tr.gan_d_steps
        ratio = self.state.d_loss_ema / max(self.state.g_loss_ema, 1e-6)
        if ratio > 1.5:
            return min(tr.gan_d_steps + 1, 3)
        if ratio < 0.5:
            return max(tr.gan_d_steps - 1, 1)
        return tr.gan_d_steps

    def validate(self) -> Dict:
        with self._meshed():
            return self._validate()

    def _validate(self) -> Dict:
        if self.val_iter is None or not ({"acoustic", "refiner"}
                                         & set(self.blocks)):
            return {}
        vals = []
        batches = self.val_iter() if callable(self.val_iter) else self.val_iter
        for batch in batches:
            b = self._place(batch)
            out = None
            mel_pred = b["mel"]  # refiner alone: refine the ground truth
            if "acoustic" in self.blocks:
                out = self.blocks["acoustic"].val_step(
                    self._pre_forward("acoustic", b, training=False))
                mel_pred = out["mel_pred"]
            if "refiner" in self.blocks:
                out = self.blocks["refiner"].val_step(
                    self._pre_forward("refiner", b, training=False), mel_pred)
            vals.append(self._global({"v": float(out["val_l1"])})["v"])
        val_l1 = float(np.mean(vals)) if vals else float("inf")
        metrics = {"val_l1": val_l1}
        if self.cfg.train.novel.sde_noise_annealing:
            self.state.noise_scale = float(np.clip(val_l1, 0.05, 1.0))
            self.state.l1_weight = float(np.clip(1.0 - val_l1, 0.1, 1.0))
        if val_l1 < self.state.best_val:
            self.state.best_val = val_l1
            metrics["best"] = True
        for cb in self.callbacks:
            cb.on_validation_end(self, metrics)
        return metrics

    @property
    def block_states(self) -> Dict[str, Dict]:
        """Each block's ``state_dict``: the checkpoint's tree."""
        return {name: b.state_dict() for name, b in self.blocks.items()}

    def save_checkpoint(self, tag: str = "last") -> None:
        if self.checkpoint_dir is None:
            return
        extra = {k: getattr(self.state, k) for k in EXTRA}
        if self.mesh is None or self.mesh.rank == 0:
            ckpt.save_checkpoint(self.checkpoint_dir, tag, self.block_states,
                                 self.state.global_step, extra)
        if self.mesh is not None:
            self.mesh.barrier()
        for cb in self.callbacks:
            cb.on_checkpoint(self, self.state.global_step)

    def restore_checkpoint(self, tag: str = "last") -> bool:
        """Load ``tag`` into the blocks and the run's state; False when
        there is no checkpoint directory or no such tag."""
        if self.checkpoint_dir is None:
            return False
        got = ckpt.restore_checkpoint(self.checkpoint_dir, tag,
                                      self.block_states)
        if got is None:
            return False
        states, step, extra = got
        for name, block in self.blocks.items():
            block.load_state_dict(states[name])
        self.state.global_step = step
        for k, default in EXTRA.items():
            setattr(self.state, k, extra.get(k, default))
        return True

    def train(self, max_steps: Optional[int] = None) -> TrainerState:
        cfg = self.cfg.train
        max_steps = max_steps or cfg.max_steps
        for cb in self.callbacks:
            cb.on_train_start(self)
        batch = next(self.train_iter, None)
        while batch is not None and self.state.global_step < max_steps:
            self.train_step(batch)
            if cfg.val_freq and self.state.global_step % cfg.val_freq == 0:
                if self.validate().get("best"):
                    self.save_checkpoint("best")
            if (cfg.checkpoint_freq
                    and self.state.global_step % cfg.checkpoint_freq == 0):
                self.save_checkpoint("last")
            batch = next(self.train_iter, None)
        self.save_checkpoint("final")
        for cb in self.callbacks:
            cb.on_train_end(self)
        return self.state
