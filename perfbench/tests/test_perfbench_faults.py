"""The correctness check sees each fault a cell can have: a run with the
timed path broken underneath (on the CPU, at the tiny size, the harness's
look for a card skipped) comes out not correct.

Serving: half of the bucket left out (its rows zeroed), one request's
answer altered where it is produced, and a stage that returns its input
unchanged (the refiner). Training: a step that leaves the state
unchanged, half of the batch left out with the mean taken over the rest
(its rows replaced by the first half's), a loss altered where it is
produced, and K3's output altered. ``FAULTS`` names them for
``readings.py --fault``, which reads them on the card at the cell's
size.
"""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import tiny_root

SERVE, TRAIN = "flagship-serve-b8", "tts-train-b16"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def run(root, cell, seed=7):
    man = harness.manifest(root)
    ctx = harness.Context(harness.load_cell(cell, root, man), seed, 0.0,
                          False, "cpu", time.perf_counter(), root)
    return harness.run_cell(ctx, man)


def _half_bucket(monkeypatch):
    from ttsx_torch.serve import SynthesisServer
    run_ = SynthesisServer.run

    def broken(self, *arrays):
        wav = run_(self, *arrays).clone()
        wav[wav.shape[0] // 2:] = 0.0
        return wav
    monkeypatch.setattr(SynthesisServer, "run", broken)


def _one_answer(monkeypatch):
    from ttsx_torch.serve import SynthesisServer
    serve = SynthesisServer.serve_batch

    def broken(self, reqs):
        outs = serve(self, reqs)
        outs[0] = outs[0] + 1e-2
        return outs
    monkeypatch.setattr(SynthesisServer, "serve_batch", broken)


def _refiner_identity(monkeypatch):
    from ttsx_torch.models import refiner
    forward = refiner.ScoreSDERefiner.forward

    def broken(self, mel0, *a, **k):
        out = forward(self, mel0, *a, **k)
        return out._replace(mel_ref=mel0)
    monkeypatch.setattr(refiner.ScoreSDERefiner, "forward", broken)


@pytest.mark.parametrize("fault", [_half_bucket, _one_answer,
                                   _refiner_identity])
def test_serving_faults_are_not_correct(tiny, monkeypatch, fault):
    assert run(tiny, SERVE)["correct"] is True
    fault(monkeypatch)
    line = run(tiny, SERVE)
    assert line["correct"] is False, line["checks"]


def _state_unchanged(monkeypatch):
    from ttsx_torch.train import optim
    monkeypatch.setattr(optim.ClippedAdamW, "step",
                        lambda self: self.schedule(self.count))


def _half_batch(monkeypatch):
    from ttsx_torch.train import blocks
    as_tensors = blocks.as_tensors

    def broken(batch, device):
        # rows B/2.. replaced by rows 0..B/2-1: the same shapes and draws,
        # every mean taken over the first half alone
        out = as_tensors(batch, device)
        half = {}
        for k, v in out.items():
            h = v.shape[0] // 2 if v.ndim else 0
            half[k] = torch.cat([v[:h], v[:h]] + ([v[2 * h:]] if h else [])) \
                if h else v
        return half
    monkeypatch.setattr(blocks, "as_tensors", broken)


def _loss_altered(monkeypatch):
    from ttsx_torch.train import losses
    composite = losses.composite_acoustic_loss

    def broken(*a, **k):
        loss, parts = composite(*a, **k)
        return loss * 1.01, parts
    monkeypatch.setattr(losses, "composite_acoustic_loss", broken)


def _k3_altered(monkeypatch):
    import ttsx_torch.ops.mel_frontend as mf
    log_mel = mf.log_mel
    monkeypatch.setattr(mf, "log_mel", lambda w, a: log_mel(w, a) + 1e-2)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _loss_altered, _k3_altered])
def test_training_faults_are_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    line = run(tiny, TRAIN)
    assert line["correct"] is False, line["checks"]


FAULTS = {f.__name__.lstrip("_"): f for f in (
    _half_bucket, _one_answer, _refiner_identity, _state_unchanged,
    _half_batch, _loss_altered, _k3_altered)}


def test_training_is_correct_unbroken(tiny):
    line = run(tiny, TRAIN)
    assert line["correct"] is True, line["checks"]
    assert torch.get_default_dtype() == torch.float32
