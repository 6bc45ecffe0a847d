"""The port's spans and counters (``ttsx_torch.utils.spans``): off they
record nothing; a recording keeps names, nesting, ids, attributes and
counters; under ``torch.profiler`` every span is also a
``user_annotation`` of the profiler's trace; and the server, the
synthesis stages, the engine step, the GAN steps, the optimizer, the
spectral norm and the collator record theirs."""
import json
import time

import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread, randn  # noqa: F401

from ttsx_torch.utils import spans

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def empty_default():
    spans.clear()
    yield
    spans.clear()


def _tree(rec):
    """{name: parent's name} over the recorder's spans."""
    return {s.name: (rec.spans[s.parent].name if s.parent is not None
                     else None) for s in rec.spans}


def _profile(fn, path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _nested():
    """Three spans of 10 ms or more: a tenth of each holds the profiler's
    own cost at its ends (a first range in a process takes about 1 ms)."""
    with spans.span("outer", id=7, kind="a"):
        x = torch.ones(64, 64)
        with spans.span("inner"):
            x = x @ x
            time.sleep(0.01)
            spans.count("things", 3)
        with spans.span("second", n=2):
            x = x + 1
            time.sleep(0.01)
        spans.count("things")
    return x


# ------------------------------------------------------------------ module
def test_off_records_nothing():
    """No recorder and no profiler: ``span`` hands back the one shared
    no-op and records nothing, ``count`` adds nothing; ``timed`` still
    times its block."""
    assert spans.span("a") is spans.span("b", id=3, k=1)
    _nested()
    with spans.timed("t") as t:
        time.sleep(0.001)
    assert t.seconds >= 1e-3
    assert not spans.recorded()
    assert spans.recorded().spans == [] and spans.recorded().counters == {}


def test_recording_keeps_tree_ids_attributes_and_counters():
    with spans.recording() as rec:
        _nested()
        with spans.span("later"):
            pass
    _nested()                               # closed: nothing more
    assert [s.name for s in rec.spans] == ["outer", "inner", "second",
                                           "later"]
    assert _tree(rec) == {"outer": None, "inner": "outer",
                          "second": "outer", "later": None}
    assert [s.id for s in rec.spans] == [7, 7, 7, None]
    assert rec.spans[0].attrs == {"kind": "a"}
    assert rec.spans[2].attrs == {"n": 2}
    assert rec.counters == {"things": 4}
    outer, inner = rec.spans[:2]
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    assert inner.seconds >= 1e-2
    assert rec.seconds("inner", "second") == pytest.approx(
        inner.seconds + rec.spans[2].seconds)
    assert not spans.recorded()             # the default stayed empty


def test_spans_are_profiler_annotations(tmp_path):
    """Under the profiler each span is a ``user_annotation`` with the same
    nesting and a duration within 10 % or 100 us of the recorded one;
    the default recorder fills only while the profiler is active, and
    holds the last session alone."""
    _nested()
    assert not spans.recorded()
    events = _profile(_nested, tmp_path / "trace.json")
    rec = spans.recorded()
    assert [s.name for s in rec.spans] == ["outer", "inner", "second"]
    assert rec.counters == {"things": 4}
    ann = {e["name"]: e for e in events if e["name"] in
           ("outer", "inner", "second")}
    assert set(ann) == {"outer", "inner", "second"}
    for s in rec.spans:
        dur = ann[s.name]["dur"] * 1e-6
        assert abs(dur - s.seconds) <= max(0.1 * s.seconds, 1e-4), s
    o = ann["outer"]
    for child in ("inner", "second"):
        c = ann[child]
        assert o["ts"] <= c["ts"] and c["ts"] + c["dur"] <= o["ts"] + o["dur"]
    with spans.recording():                 # the profiler has stopped
        _nested()
    assert len(rec.spans) == 3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("next"):
            spans.count("more")
    assert [s.name for s in rec.spans] == ["next"]  # a new session's record
    assert rec.counters == {"more": 1}
    _nested()
    assert len(rec.spans) == 1


# ------------------------------------------------------------------ server
def test_serve_batch_records_its_tree_and_frames():
    from test_torch_port import _requests, _tiny_pipe
    from ttsx_torch.serve import SynthesisServer
    pipe = _tiny_pipe()
    srv = SynthesisServer(pipe, device="cpu", max_batch=2, frames=16,
                          scale_stats=randn(5, 160), bf16=False)
    lens = [16, 10, 5]
    with spans.recording() as rec:
        outs = srv.serve_batch(_requests(lens, pipe.cfg))
    assert [len(o) for o in outs] == [n * 32 for n in lens]
    calls = rec.named("serve.call")
    assert [c.id for c in calls] == [0, 1]
    serve = ("serve.pad", "serve.upload", "serve.run", "serve.fetch",
             "serve.trim")
    synth = ("synth.acoustic", "synth.refiner", "synth.gst",
             "synth.generator")
    for c in calls:
        inside = [s for s in rec.spans if s.id == c.id and s is not c]
        assert [s.name for s in inside] == list(serve[:3]) + list(synth) \
            + list(serve[3:])
        run = rec.spans.index(next(s for s in inside
                                   if s.name == "serve.run"))
        for s in inside:
            want = run if s.name in synth else rec.spans.index(c)
            assert s.parent == want, s
    assert rec.counters == {"serve.frames_requested": sum(lens),
                            "serve.frames_run": 2 * 2 * 16}


# ------------------------------------------------------------------ training
def test_engine_step_records_its_tree_and_times():
    """One engine step of the three blocks (two micro-batches, the refiner
    on, a GAN step with R1): the ``train.*``, ``gan.*``,
    ``optim.update`` and ``nn.spectral_normalize`` spans, all with the
    step's id; ``step_time_s`` is the ``train.step`` span's duration."""
    from torch_train_helpers import gan_cfg
    from ttsx_torch.data.synthetic import synthetic_batch
    from ttsx_torch.train.engine import UnifiedTrainer
    cfg = gan_cfg(accum=2)
    batches = [synthetic_batch(cfg, batch=2, frames=5, seed=s)
               for s in range(2)]
    tr = UnifiedTrainer(cfg, iter(batches[1:]), device="cpu")
    with spans.recording() as rec:
        m = tr.train_step(batches[0])
    step, = rec.named("train.step")
    assert step.id == 0 and step.parent is None
    assert m["step_time_s"] == step.seconds == tr.state.step_times[-1]
    assert {s.id for s in rec.spans} == {0}
    top = [s.name for s in rec.spans if s.parent == 0]
    assert top == ["train.place", "train.next_batch", "train.place",
                   "train.acoustic", "train.metrics", "train.refiner",
                   "train.metrics", "train.gan"]
    under = {s.name for s in rec.spans
             if s.parent is not None and rec.spans[s.parent].name
             == "train.gan"}
    assert under == {"gan.disc_step", "gan.gen_step", "train.metrics"}
    disc, = rec.named("gan.disc_step")
    assert disc.attrs == {"r1": True}
    modules = [s.attrs["module"] for s in rec.named("optim.update")]
    assert modules == ["AcousticModel", "ScoreSDERefiner",
                       "MultiPeriodDiscriminator", "MultiScaleDiscriminator",
                       "MultiBandDiscriminator", "Generator",
                       "GlobalStyleTokens"]
    sn = rec.named("nn.spectral_normalize")
    voc = tr.blocks["vocoder"]
    n_sn = sum(type(x).__name__ == "SNConv" for d in (voc.mpd, voc.msd,
                                                      voc.mbd)
               for x in d.modules())
    # D's real and fake passes in disc_step, G's fake and real in gen_step
    assert len(sn) == 4 * n_sn
    assert all(rec.spans[s.parent].name != "train.step" for s in sn)


def test_collate_time_is_its_span():
    from ttsx_torch.core.config import AudioConfig
    from ttsx_torch.data.collate import CollatorConfig, TTSCollator
    audio = AudioConfig(sample_rate=16000, n_fft=256, win_length=256,
                        hop_length=64, n_mels=32)
    coll = TTSCollator(CollatorConfig(audio=audio, augment=False,
                                      cache_features=False,
                                      bucket_wav=1024), device="cpu")
    rng = np.random.default_rng(0)
    items = [dict(wav=(0.1 * rng.normal(size=n)).astype(np.float32),
                  text_ids=np.arange(3), text_length=3,
                  text_emb=np.zeros((3, 8), np.float32), speaker_id=0,
                  domain_id=0, style_id=1, transcript="a b c")
             for n in (1500, 2500)]
    with spans.recording() as rec:
        batch = coll(items)
    span, = rec.named("collate")
    assert batch["collate_time"] == span.seconds > 0
    assert batch["mel"].shape[0] == 2
    batch = coll(items)                     # off: still timed
    assert batch["collate_time"] > 0 and len(rec.spans) == 1
