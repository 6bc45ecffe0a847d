"""Whole engine steps of ``UnifiedTrainer.train_step`` over the CLI's data
stream (``cli/main.py::data_streams``).

Set-up writes the traffic's seeded wav tree under ``TMPDIR``, builds the
stream (dataset -> collator with K3 and the f0 / energy features on the
card -> trainer batches) and the trainer with its three default blocks,
loads the benchmark's weights into every trained module
(``perfbench.weights``, from the seed) and restarts the generator's EMA
at them. The run's seed draws the weights and the wavs' signals; the
configuration's own ``train.seed`` orders the stream and seeds the
blocks' draws, as in any run of the program, so that every seed trains
on batches of the same shapes (the work of a step follows its batch's
longest wav). It then takes the ``checked_steps`` first engine
steps through ``train_step`` itself, which warm every kind of step the
window takes (an R1 discriminator step, a refiner update, the generator
step, K3) and are the steps the reference follows. The window starts at
the next step and ends at the first step boundary after both the run's
seconds and ``min_window_steps`` steps.

End to end: ``train_step_ms``, the window's wall time over its engine
steps, data collation included; ``setup_s``, the process's start to the
window's first step.

Correctness, over the checked steps (the benchmark records, and takes
nothing else from, the program's run): the micro-batches the stream
gave, the draws each block's step made, each loss the step returned,
each leaf's first gradient norm (from AdamW's first moment after its
first update) and each leaf's change over the steps; each K3 launch's
input and output. After the window, with the trainer freed, the
reference (``perfbench/reference``, float32, TF32 off) takes the same
steps from the same weights on the same batches and draws, and
``perfbench.compare`` gives the worst leaf's and step's gaps.

Traced run: the block steps are timed by wrappers that synchronise the
card (``block_ms.*``), ``torch.profiler`` covers ``trace_steps`` whole
steps from the ``trace_from``-th of the window, K3's input shapes are
recorded for its count, and each window step's shapes are kept for the
FLOP count of ``mfu.train``.
"""
from __future__ import annotations

import gc
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from perfbench import compare, traffic
from perfbench.trace import Stretch
from perfbench.weights import draw_weights, load_weights

LOSSES = ("acoustic/loss", "refiner/loss", "vocoder/d_loss", "vocoder/g_loss")


def trained_modules(trainer) -> Dict[str, object]:
    b = trainer.blocks
    voc = b["vocoder"]
    return {"acoustic": b["acoustic"].model, "refiner": b["refiner"].model,
            **{f"vocoder.{n}": voc.states[n].module for n in voc.PARTS}}


def trained_states(trainer) -> Dict[str, object]:
    b = trainer.blocks
    voc = b["vocoder"]
    return {"acoustic": b["acoustic"].state, "refiner": b["refiner"].state,
            **{f"vocoder.{n}": voc.states[n] for n in voc.PARTS}}


class Recorder:
    """Draws from a block's own source, each kept on the host as (kind,
    shape, value), in the order they were made: a rewind (the acoustic
    block's next micro-batch) rewinds the source and keeps every record,
    so the records hold each micro-batch's own draws."""

    def __init__(self, source):
        self.source = source
        self.records: List[tuple] = []

    def __getattr__(self, name):
        return getattr(self.source, name)

    def _keep(self, kind, shape, value):
        self.records.append((kind, tuple(shape), value.detach().cpu()))
        return value

    def uniform(self, shape, low=0.0, high=1.0):
        return self._keep("uniform", shape,
                          self.source.uniform(shape, low, high))

    def normal(self, shape):
        return self._keep("normal", shape, self.source.normal(shape))

    def randint(self, shape, low, high):
        return self._keep("randint", shape,
                          self.source.randint(shape, low, high))

    def bernoulli(self, p, shape):
        return self._keep("bernoulli", shape, self.source.bernoulli(p, shape))

    def mark(self):
        return self.source.mark()

    def rewind(self, mark) -> None:
        self.source.rewind(mark)


class Feed:
    """The stream, counted: every batch it hands out (the engine pulls the
    later micro-batches itself) adds its ``collate_time``; while
    ``keep`` is on, each batch's arrays are kept."""

    def __init__(self, stream):
        self.stream = stream
        self.keep = False
        self.kept: List[dict] = []
        self.collate_s = 0.0
        self.batches = 0
        self.shapes: List[dict] = []

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.stream)
        self.collate_s += float(b.get("collate_time", 0.0))
        self.batches += 1
        self.shapes.append({k: (v.shape, str(v.dtype)) for k, v in b.items()
                            if isinstance(v, np.ndarray)})
        if self.keep:
            self.kept.append({k: np.array(v) for k, v in b.items()
                              if isinstance(v, np.ndarray)})
        return b


class Timed:
    """A block method wrapped to add its synchronised host time to
    ``totals[name]``."""

    def __init__(self, fn, name, totals, sync):
        self.fn, self.name, self.totals, self.sync = fn, name, totals, sync

    def __call__(self, *a, **k):
        self.sync()
        t = time.perf_counter()
        try:
            return self.fn(*a, **k)
        finally:
            self.sync()
            self.totals[self.name] = self.totals.get(self.name, 0.0) \
                + time.perf_counter() - t


def run(ctx) -> dict:
    import torch
    import ttsx_torch.ops.mel_frontend as mf
    from ttsx_torch.cli.main import data_streams
    from ttsx_torch.core.config import TTSXConfig, from_dict
    from ttsx_torch.core.device import set_f32_numerics
    from ttsx_torch.data.dataset import write_wav
    from ttsx_torch.train.engine import UnifiedTrainer
    from perfbench.reference.train.engine import first_grad_hook

    cell, tr, dev = ctx.cell, ctx.cell.traffic, ctx.device

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    if dev == "cuda":
        # the port's numerics on the card, as its training entry
        # (``cli/main.py::device_from_args``) states them: no TF32
        set_f32_numerics()
    cfg = from_dict(TTSXConfig, cell.config["config"])
    data_root = Path(tempfile.mkdtemp(prefix="perfbench-wavs-"))
    try:
        traffic.write_wav_tree(data_root, tr, ctx.seed, write_wav)
        stream, _ = data_streams(cfg, str(data_root), dev)
        feed = Feed(stream)
        trainer = UnifiedTrainer(cfg, feed, None, device=dev)
        mods = trained_modules(trainer)
        for name, mod in mods.items():
            load_weights(mod, draw_weights(mod, compare.module_seed(ctx.seed, name),
                                           dev))
        trainer.blocks["vocoder"].states["gen"].reset_ema()
        start = {name: {k: p.detach().cpu().clone()
                        for k, p in mod.named_parameters()}
                 for name, mod in mods.items()}

        # the checked steps: record draws, batches, first gradients, K3
        blocks = trainer.blocks
        rec = {"acoustic": Recorder(blocks["acoustic"].state.draws),
               "refiner": Recorder(blocks["refiner"].state.draws),
               "vocoder": Recorder(blocks["vocoder"].states["gen"].draws)}
        blocks["acoustic"].state.draws = rec["acoustic"]
        blocks["refiner"].state.draws = rec["refiner"]
        blocks["vocoder"].states["gen"].draws = rec["vocoder"]
        first: Dict[str, Dict[str, float]] = {}
        steps_fn = {}
        for name, st in trained_states(trainer).items():
            steps_fn[name] = st.tx.step
            first_grad_hook(st, name, first)
        k3_pairs, k3_shapes, k3_on = [], [], {"pairs": True, "shapes": False}
        log_mel = mf.log_mel

        def k3(wav, audio):
            # K3's launch counts on the wrapper in its place (``_launch``
            # adds to the module's ``log_mel``)
            out = log_mel(wav, audio)
            if k3_on["pairs"]:
                k3_pairs.append((wav.detach().cpu(), out.detach().cpu()))
            if k3_on["shapes"]:
                k3_shapes.append(tuple(wav.shape))
            return out
        k3.launches = getattr(log_mel, "launches", 0)
        mf.log_mel = k3
        losses, step_batches = [], []
        feed.keep = True
        for _ in range(tr["checked_steps"]):
            n0 = len(feed.kept)
            m = trainer.train_step(next(feed))
            losses.append({k: float(m[k]) for k in LOSSES if k in m})
            step_batches.append(feed.kept[n0:])
        feed.keep = False
        k3_on["pairs"] = False
        for name, st in trained_states(trainer).items():
            st.tx.step = steps_fn[name]
        blocks["acoustic"].state.draws = rec["acoustic"].source
        blocks["refiner"].state.draws = rec["refiner"].source
        blocks["vocoder"].states["gen"].draws = rec["vocoder"].source
        change = compare.change_norms(start, {
            name: {k: p.detach().cpu() for k, p in mod.named_parameters()}
            for name, mod in mods.items()})
        draws = {k: r.records for k, r in rec.items()}
        sync()
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()

        # the window (none for the readings)
        totals: Dict[str, float] = {}
        if ctx.trace:
            _time_blocks(trainer, totals, sync)
        shapes, failed, stretch = [], 0, None
        collate0, steps = feed.collate_s, 0
        setup_s = time.perf_counter() - ctx.t0
        t_start = time.perf_counter()
        while not ctx.control:
            if ctx.trace and steps == tr["trace_from"]:
                k3_on["shapes"] = True
                stretch = Stretch(dev)
                stretch.__enter__()
            n0 = feed.batches
            s0 = time.perf_counter()
            step_no = trainer.state.global_step
            mpd_before = trainer.blocks["vocoder"].states["mpd"].step
            try:
                m = trainer.train_step(next(feed))
                ok = "vocoder/oom" not in m and all(
                    np.isfinite(float(m[k])) for k in LOSSES if k in m)
            except (RuntimeError, ValueError) as e:
                ctx.note(step=steps, error=repr(e))
                m, ok = {}, False
            failed += 0 if ok else 1
            steps += 1
            if ctx.trace:
                shapes.append(dict(
                    step=step_no, batches=n0, mpd_step=mpd_before,
                    d_steps=int(m.get("vocoder/d_steps", 0)),
                    seconds=time.perf_counter() - s0,
                    traced=stretch is not None and steps <= tr["trace_from"]
                    + tr["trace_steps"]))
            if stretch is not None and steps == tr["trace_from"] \
                    + tr["trace_steps"]:
                stretch.__exit__(None, None, None)
                k3_on["shapes"] = False
            if (time.perf_counter() - t_start >= ctx.seconds
                    and steps >= tr["min_window_steps"]
                    and (not ctx.trace
                         or steps >= tr["trace_from"] + tr["trace_steps"])):
                break
        window_s = max(time.perf_counter() - t_start, 1e-9)
        if hasattr(log_mel, "launches"):
            log_mel.launches = k3.launches
        mf.log_mel = log_mel
        collate_s = feed.collate_s - collate0
        peak = int(torch.cuda.max_memory_allocated()) if dev == "cuda" else 0
        if stretch is not None:
            stretch.reduce()
        ctx.note(steps=steps, failed=failed, window_s=window_s)
        trace_batches = None
        if ctx.trace:
            trace_batches = _window_shapes(feed, shapes, cfg)
        del trainer, blocks, mods, feed, stream
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(data_root, ignore_errors=True)

    got = dict(losses=losses, first_grad=first, change=change,
               k3=k3_pairs)
    try:
        ref = compare.reference_train(cell.config["config"], ctx.seed, draws,
                                      step_batches, dev)
        where: dict = {}
        gaps = compare.train_gaps(got, ref, cell.config["config"]["audio"],
                                  where)
        ctx.note(worst_leaf=where)
    except (ValueError, IndexError, RuntimeError) as e:
        # the program's draws or batches do not fit the reference's step:
        # the step took another path than the configuration states
        ctx.note(reference_error=repr(e))
        ref, gaps = None, dict.fromkeys(cell.limits, float("inf"))
    lim = cell.limits
    checks = {k: (v, lim[k]) for k, v in gaps.items()}
    checks["failed_steps"] = (failed, 0)
    correct = all(v <= lim[k] for k, v in gaps.items()) and failed == 0
    out = dict(correct=correct, attempted=steps, failed=failed,
               memory_peak_bytes=peak, checks=checks,
               e2e={"train_step_ms": 1e3 * window_s / max(steps, 1),
                    "setup_s": setup_s})
    if ctx.control and ref is not None:
        ctl = compare.reference_train(cell.config["config"], ctx.seed, draws,
                                      step_batches, dev, tf32=True)
        ctl["k3"] = compare.control_k3(k3_pairs,
                                       cell.config["config"]["audio"])
        where = {}
        out["control"] = compare.train_gaps(ctl, ref,
                                            cell.config["config"]["audio"],
                                            where)
        ctx.note(control_worst_leaf=where)
        out["detail"] = {name: {k: side[k] for k in
                                ("losses", "first_grad", "change")}
                         for name, side in (("program", got),
                                            ("reference", ref),
                                            ("control", ctl))}
    if ctx.trace and stretch is not None:
        plain = [s for s, w in zip(trace_batches, shapes) if not w["traced"]]
        flops = compare.window_flops(cell.config["config"], plain)
        plain_s = sum(w["seconds"] for w in shapes if not w["traced"])
        out.update(busy_s=stretch.trace["busy_s"], window_s=stretch.window_s,
                   breakdown={"device_ops": stretch.trace["device_ops"],
                              "idle_gaps": stretch.trace["idle_gaps"]},
                   record=dict(kind="train", device=dev,
                               trace=stretch.trace,
                               stretch_s=stretch.window_s,
                               steps=steps, window_s=window_s,
                               blocks_s=totals, collate_s=collate_s,
                               k3_shapes=k3_shapes,
                               audio=cell.config["config"]["audio"],
                               mel_nnz=compare.mel_nnz(
                                   cell.config["config"]["audio"]),
                               untraced_flops=flops,
                               untraced_s=plain_s))
    return out


def _time_blocks(trainer, totals, sync) -> None:
    """Wrap each block's step methods (on the instances) with ``Timed``."""
    b = trainer.blocks
    for obj, meth, name in ((b["acoustic"], "train_step_accum", "acoustic"),
                            (b["acoustic"], "train_step", "acoustic"),
                            (b["refiner"], "train_step", "refiner"),
                            (b["vocoder"], "disc_step", "vocoder"),
                            (b["vocoder"], "gen_step", "vocoder")):
        setattr(obj, meth, Timed(getattr(obj, meth), name, totals, sync))


def _window_shapes(feed, shapes, cfg) -> List[dict]:
    """Each window step's FLOP signature: its micro-batches' shapes and
    dtypes, a refiner update or not, and the R1 flag of each
    discriminator step."""
    tr, vc = cfg.train, cfg.vocoder
    return [dict(micro=[{k: (list(shape), dt) for k, (shape, dt)
                         in feed.shapes[i].items()}
                        for i in range(s["batches"], min(
                            s["batches"] + tr.grad_accum_steps,
                            len(feed.shapes)))],
                 refiner=s["step"] % tr.refiner_update_freq == 0,
                 r1=[(s["mpd_step"] + j) % vc.r1_interval == 0
                     for j in range(s["d_steps"])])
            for s in shapes]
