"""CPU tests of the readers of the program's own spans and counters
(``perfbench/program_spans.py``): each reads a synthetic record and the
program's default recorder filled under the profiler, and gives nothing
on an empty recorder or a program without spans; a traced tiny serving
run reports the padding the traffic implies.

    python -m pytest perfbench/tests -q
"""
from __future__ import annotations

import math
import sys
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.test_perfbench_harness import (  # noqa: F401
    SERVE, TRAIN, run_tiny, tiny)

NEW = ("serve_pad_waste_pct", "server_host_ms", "gan_ms.disc", "gan_ms.gen",
       "specnorm_ms.train")


@pytest.fixture(autouse=True)
def empty_default():
    from ttsx_torch.utils.spans import clear
    clear()
    yield
    clear()


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()


def _serve_calls():
    from ttsx_torch.utils.spans import count, span
    for i in range(2):
        with span("serve.call", id=i):
            for name in ("serve.pad", "serve.upload", "serve.run",
                         "serve.trim"):
                with span(name):
                    time.sleep(0.002)
            count("serve.frames_requested", 300)
            count("serve.frames_run", 800)


def _train_steps():
    from ttsx_torch.utils.spans import span
    for i in range(2):
        with span("train.step", id=i):
            with span("train.gan"):
                for _ in range(3):
                    with span("nn.spectral_normalize"):
                        time.sleep(0.001)


SERVE_REC = dict(kind="serve", calls=2, trace={"ranges": {}})
TRAIN_REC = dict(kind="train", steps=9, trace={
    "ranges": {"gan.disc_step": 0.5, "gan.gen_step": 0.8,
               "nn.spectral_normalize": 0.03},
    "idle_gaps": [["(no host event)", 0.2], ["nn.spectral_normalize", 0.05],
                  ["aten::div", 0.01]]})


def _profiled_both():
    """The serving and training spans in one profiler session (the
    default recorder keeps the last session alone)."""
    _profiled(lambda: (_serve_calls(), _train_steps()))


def _read(name, record):
    return harness.metric_reader(name).read(record)


def test_readers_of_a_filled_recorder():
    from ttsx_torch.utils.spans import recorded
    _profiled_both()
    rec = recorded()
    assert math.isclose(_read("serve_pad_waste_pct", SERVE_REC),
                        100 * (1 - 600 / 1600))
    host = 1e3 * rec.seconds("serve.pad", "serve.upload", "serve.trim") / 2
    assert math.isclose(_read("server_host_ms", SERVE_REC), host)
    assert host >= 6.0
    # per recorded train.step span, not per the record's window steps
    assert math.isclose(_read("gan_ms.disc", TRAIN_REC), 250.0)
    assert math.isclose(_read("gan_ms.gen", TRAIN_REC), 400.0)
    # the norm's kernels and the idle named after it, not its host time
    assert math.isclose(_read("specnorm_ms.train", TRAIN_REC), 40.0)
    assert rec.seconds("nn.spectral_normalize") >= 6e-3
    # each reader keeps to its own kind of cell
    for name in NEW[:2]:
        assert _read(name, TRAIN_REC) is None
    for name in NEW[2:]:
        assert _read(name, SERVE_REC) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_give_nothing_on_an_empty_recorder(name):
    record = SERVE_REC if name.startswith("serve") else TRAIN_REC
    assert _read(name, record) is None
    _serve_calls()                          # no profiler: nothing recorded
    _train_steps()
    assert _read(name, record) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_give_nothing_without_the_program_module(name, monkeypatch):
    """The parent tree has no ``ttsx_torch.utils.spans``: the readers give
    nothing and raise nothing."""
    _profiled_both()
    monkeypatch.setitem(sys.modules, "ttsx_torch.utils.spans", None)
    record = SERVE_REC if name.startswith("serve") else TRAIN_REC
    assert _read(name, record) is None


def test_traced_tiny_serving_reports_its_padding(tiny):
    """A traced tiny serving run: the padding share is the traffic's,
    over the traced calls' requests; every new serving metric is in the
    line."""
    from perfbench import traffic
    from ttsx_torch.utils.spans import recorded
    line = run_tiny(tiny, SERVE, trace=True)
    assert {"serve_pad_waste_pct", "server_host_ms"} <= set(line["metrics"])
    cell = harness.load_cell(SERVE, tiny)
    tr = cell.traffic
    drv = harness.driver("serve_bucket", tiny)
    pool = traffic.serve_pool(tr, drv.dims(drv.port_config(cell)), 2**31 + 5)
    B, T = tr["batch"], tr["frames"]
    asked = sum(min(len(pool[k]["text_emb"]), T)
                for i in range(tr["trace_from"],
                               tr["trace_from"] + tr["trace_calls"])
                for k in traffic.call_indices(i, B, len(pool)))
    want = 100 * (1 - asked / (tr["trace_calls"] * B * T))
    assert math.isclose(line["metrics"]["serve_pad_waste_pct"]["value"],
                        want)
    assert len(recorded().named("serve.call")) == tr["trace_calls"]


def test_traced_tiny_training_records_its_steps(tiny):
    """A traced tiny training run records the traced steps, their GAN
    steps and spectral norms; on the CPU the trace has no device kernel,
    so none of the device-trace readers reads anything, and none
    raises."""
    from ttsx_torch.utils.spans import recorded
    line = run_tiny(tiny, TRAIN, trace=True)
    rec = recorded()
    steps = len(rec.named("train.step"))
    assert steps == harness.load_cell(TRAIN, tiny).traffic["trace_steps"]
    assert not set(NEW[2:]) & set(line["metrics"])
    assert len(rec.named("gan.disc_step")) >= steps
    assert len(rec.named("nn.spectral_normalize")) >= steps
