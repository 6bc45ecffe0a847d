"""The port's eval package and training hooks against ``ttsx`` on the CPU:
config files (YAML and JSON, each package reading the other's), the MCD
(index and DTW pairing), the timers and CI gates, ``main_bench``'s gate,
``evaluate_acoustic`` and the microbenchmarks, the ``Observer`` (also
inside the engine, port alone), the file-size tool and the console
scripts. The speaker encoder's ``torch.export`` program is tested with
its console scripts (``tests/test_torch_refenc_cli.py``).

Tiny widths. Weights come from the reference (``init_like`` trees)
through ``weights.py``. Tolerances: numpy paths exactly (the MCD within
1e-12); ``val_loss`` within 1e-5 relative.
"""
import json
import sys
import time
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import init_like, port, randn
from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)

from ttsx.core import config as jc
from ttsx_torch.core import config as tc

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------------ configs
def _restrict(ref, like):
    """``ref`` cut to the keys of ``like`` (the port's tree carries no
    ``mesh``)."""
    if isinstance(like, dict):
        return {k: _restrict(ref[k], v) for k, v in like.items()}
    return ref


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_config_files_read_across_packages(tmp_path, suffix):
    cfg = tc.TTSXConfig(acoustic=tc.AcousticConfig(hidden_channels=64),
                        train=tc.TrainConfig(lr=3e-4, max_steps=7),
                        refiner=tc.RefinerConfig(vq_dims=(80, 40), vq_codes=(8, 4)))
    want = tc.to_dict(cfg)
    tc.save_config(cfg, tmp_path / f"port{suffix}")
    assert _restrict(jc.to_dict(jc.load_config(tmp_path / f"port{suffix}")),
                     want) == want
    assert tc.load_config(tmp_path / f"port{suffix}") == cfg
    jc.save_config(jc.from_dict(jc.TTSXConfig, want), tmp_path / f"ref{suffix}")
    got = tc.load_config(tmp_path / f"ref{suffix}")
    assert tc.to_dict(got) == want and got == cfg
    ref_cfg = tc.load_config(tmp_path / f"ref{suffix}", tc.RefEncConfig)
    assert ref_cfg == tc.RefEncConfig()   # no RefEncConfig key in the file


def test_yaml_config_without_yaml_raises(tmp_path, monkeypatch):
    tc.save_config(tc.TTSXConfig(), tmp_path / "c.yaml")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        tc.load_config(tmp_path / "c.yaml")
    with pytest.raises(ImportError):
        tc.save_config(tc.TTSXConfig(), tmp_path / "d.yml")
    tc.save_config(tc.TTSXConfig(), tmp_path / "d.json")
    assert tc.load_config(tmp_path / "d.json") == tc.TTSXConfig()


# ---------------------------------------------------------------------- MCD
def test_mcd_matches_reference():
    from ttsx.eval.metrics import log_mel_to_cepstra as jcep
    from ttsx.eval.metrics import mel_cepstral_distortion as jmcd
    from ttsx_torch.eval import mel_cepstral_distortion
    from ttsx_torch.eval.metrics import log_mel_to_cepstra
    a, b = randn(0, 40, 80, scale=2.0), randn(1, 33, 80, scale=2.0)
    b[:20] += a[5:25]
    np.testing.assert_array_equal(log_mel_to_cepstra(a), jcep(a))
    for align in (False, True):
        for n_mfcc in (13, 24):
            got = mel_cepstral_distortion(a, b, n_mfcc, align=align)
            ref = jmcd(a, b, n_mfcc, align=align)
            assert abs(got - ref) <= 1e-12 and got > 0
    assert mel_cepstral_distortion(a, a) == 0.0


# ---------------------------------------------------------- timers and gates
def _slow(x):
    time.sleep(0.004)
    return x


def test_timers_and_gates_match_reference():
    """The same keys as the reference's; a slow stub fails both gates in
    both packages; CPU tensors are not synchronized on."""
    from ttsx.eval import benchmarks as J
    from ttsx_torch.eval import benchmarks as P
    x, jx = torch.zeros(3), jnp.zeros(3)
    fast = lambda a: a  # noqa: E731
    got, ref = P.time_fn(fast, x, runs=3), J.time_fn(fast, jx, runs=3)
    assert set(got) == set(ref) and got["runs"] == ref["runs"] == 3
    assert got["min_s"] <= got["mean_s"]
    got = P.rtf(fast, x, audio_seconds=2.0, runs=2)
    ref = J.rtf(fast, jx, audio_seconds=2.0, runs=2)
    assert set(got) == set(ref)
    assert got["rtf"] == got["mean_s"] / 2.0
    for mod, a in ((P, x), (J, jx)):
        res = mod.ci_latency_gate(fast, fast, (a,), (a,), factor=1e9, runs=2)
        assert set(res) == {"model", "baseline", "ratio"}
        with pytest.raises(mod.CIGateError, match="baseline"):
            mod.ci_latency_gate(_slow, fast, (a,), (a,), factor=2.0, runs=2)
        with pytest.raises(mod.CIGateError, match="budget"):
            mod.time_budget_gate(_slow, a, max_avg_time=0.001, runs=2)
        assert set(mod.time_budget_gate(fast, a, runs=2)) == set(got) - {
            "rtf", "rtf_best"}
    out = {"a": [x, (x, 1)], "b": None}
    assert P.block_until_ready(out) is out


def test_bench_gate_passes_and_fails(monkeypatch, capsys):
    """``main_bench``'s two outcomes, its timer stubbed: the acoustic model
    within ``ci_latency_factor`` of the MLP gives rc 0 and the ratio; past
    it rc 1 and the error. Each call is the default AcousticConfig at
    batch 2 x 128 frames or the conformer_layers-deep MLP."""
    from ttsx_torch.cli.main import main_bench
    from ttsx_torch.eval import benchmarks
    calls = []

    def stub(mean):
        def time_fn(fn, *args, runs=20, warmup=2):
            calls.append(tuple(a.shape for a in args))
            fn(*args)
            return {"mean_s": mean(len(args)), "std_s": 0.0,
                    "min_s": 0.0, "runs": runs}
        return time_fn
    monkeypatch.setattr(benchmarks, "time_fn", stub(
        lambda n: 0.019 if n == 3 else 0.001))
    assert main_bench(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["pass"] and out["ratio"] == pytest.approx(19.0)
    assert calls == [((2, 128, 384), (2, 128, 18), (2, 6)), ((2, 128, 384),)]
    monkeypatch.setattr(benchmarks, "time_fn", stub(
        lambda n: 0.021 if n == 3 else 0.001))
    assert main_bench(["--device", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out.strip())
    assert out["pass"] is False and "20.0x baseline" in out["error"]


# ------------------------------------------------------------- eval names
EVAL_MODULES = ("parity_common", "parity", "parity_aux", "parity_refenc",
                "parity_prosody", "parity_vocoder", "parity_e2e",
                "parity_diar", "record_baseline", "rule_calibration")


def test_eval_package_names_match_reference():
    """The package's names, and each harness module's functions and
    constants (its helpers with a leading underscore included)."""
    import importlib
    import inspect
    import ttsx.eval as J
    import ttsx_torch.eval as P
    renamed = {"export_stablehlo": "export_pt2", "load_stablehlo": "load_pt2"}
    names = [n for n in dir(J) if not n.startswith("_") and callable(
        getattr(J, n)) or n == "MOS_PLACEHOLDER"]
    assert len(names) >= 17
    for n in names:
        assert hasattr(P, renamed.get(n, n)), n
    assert P.MOS_PLACEHOLDER == J.MOS_PLACEHOLDER
    for mod in EVAL_MODULES:
        jm = importlib.import_module(f"ttsx.eval.{mod}")
        pm = importlib.import_module(f"ttsx_torch.eval.{mod}")
        own = [n for n, v in vars(jm).items() if (
            inspect.isfunction(v) and v.__module__ == jm.__name__
            or n.lstrip("_").isupper() and not callable(v))]
        assert own, mod
        for n in own:
            assert hasattr(pm, n), f"{mod}.{n}"
    assert set(P.parity_aux.EXPERIMENTS) == set(
        importlib.import_module("ttsx.eval.parity_aux").EXPERIMENTS)


# ---------------------------------------------------------- acoustic eval
def test_evaluate_acoustic_matches_reference(tmp_path):
    from ttsx.eval.acoustic_eval import evaluate_acoustic as jeval
    from ttsx.models.acoustic import AcousticModel as J
    from ttsx_torch.eval import evaluate_acoustic, microbenchmarks
    from ttsx_torch.models.acoustic import AcousticModel
    cfg = tc.AcousticConfig(text_emb_dim=12, speaker_dim=4,
                            hidden_channels=16, conformer_layers=1,
                            attention_heads=2, transformer_dim=24,
                            num_layers=2)
    jm = J(jc.from_dict(jc.AcousticConfig, tc.to_dict(cfg)))
    rng = np.random.default_rng(0)

    def batch(seed, B, T, ids=True):
        b = dict(text_emb=randn(seed, B, T, 12), prosody=randn(seed + 1, B, T, 18),
                 emotion_probs=rng.dirichlet(np.ones(6), B).astype(np.float32),
                 mel=randn(seed + 2, B, T, 80), speaker=randn(seed + 3, B, 4))
        if ids:
            b["speaker_id"] = np.arange(B) % 2
        return b
    batches = [batch(0, 3, 10), batch(10, 3, 10), batch(20, 3, 10, False)]
    v = init_like(jm, batches[0]["text_emb"], batches[0]["prosody"],
                  batches[0]["emotion_probs"], speaker=batches[0]["speaker"])
    ann = tmp_path / "validation_annotations.json"
    ann.write_text(json.dumps({"items": [
        {"predicted": "happy", "label": "happy"},
        {"predicted": "sad", "label": "happy"},
        {"predicted": "calm", "label": "calm"}]}))
    jitted = type("Jitted", (), {"apply": staticmethod(jax.jit(
        jm.apply, static_argnames=("deterministic",)))})
    ref = jeval(jitted, v, batches, str(ann))
    got = evaluate_acoustic(port(AcousticModel(cfg), v), batches, str(ann))
    assert set(got) == set(ref) == {"val_loss", "mos", "silhouette",
                                    "emotion_accuracy"}
    assert got["val_loss"] == pytest.approx(ref["val_loss"], rel=1e-5)
    for k in ("mos", "silhouette", "emotion_accuracy"):
        assert got[k] == ref[k], k
    assert got["emotion_accuracy"] == pytest.approx(2 / 3)
    empty = evaluate_acoustic(port(AcousticModel(cfg), v), [],
                              str(tmp_path / "none.json"))
    assert np.isnan(empty["val_loss"]) and set(empty) == {"val_loss", "mos"}
    mb = microbenchmarks(runs=1, frames=16, device="cpu")
    assert set(mb) == {"acoustic", "prosody"}
    assert all(set(r) == {"mean_s", "std_s", "min_s", "runs"}
               for r in mb.values())


# ----------------------------------------------------------------- observer
def tag_batch(stage, batch):
    """An observer transform: None on "refiner" (keep the batch), raises
    on a batch marked "bad", else the batch tagged with its stage."""
    if batch.get("bad"):
        raise ValueError("bad batch")
    if stage == "refiner":
        return None
    return {**batch, "seen": stage}


def test_observer_matches_reference():
    from ttsx.train.observer import Observer as J
    from ttsx_torch.train.observer import Observer
    seq = [(stage, step, training, bad)
           for step in range(5) for stage in ("acoustic", "refiner",
                                              "vocoder")
           for training in (True, False) for bad in (False, step == 3)]
    policies = [None, {"stages": ["acoustic", "refiner"], "every": 2},
                {"train": False}, {"val": False, "every": 0}]
    for target in (tag_batch, "test_torch_eval:tag_batch"):
        for policy in policies:
            got, ref = Observer(target, policy), J(target, policy)
            for stage, step, training, bad in seq:
                batch = {"x": step, "bad": bad}
                assert got.pre_forward(stage, batch, step, training) == \
                    ref.pre_forward(stage, batch, step, training)
            assert (got.calls, got.errors) == (ref.calls, ref.errors)
            assert got.calls > 0 or policy == {"train": False}
    for bad in ("no_colon", "json:__doc__", 3):
        with pytest.raises((ValueError, TypeError)) as e:
            Observer(bad)
        with pytest.raises(e.type):
            J(bad)


def _scale_mel(stage, batch):
    return {**batch, "mel": batch["mel"] * 0.5,
            "prosody": batch["prosody"] + 0.25}


def test_engine_applies_the_observer_at_every_stage():
    """Port alone (the reference's engine test takes minutes): a step and
    a validation with a transforming observer equal the same on the
    transformed batches without one, micro-batches included; the
    observer is called once per stage and micro-batch."""
    from torch_train_helpers import batch_of, tiny_cfg
    from ttsx_torch.train.blocks import as_tensors
    from ttsx_torch.train.engine import UnifiedTrainer
    from ttsx_torch.train.observer import Observer
    cfg = tiny_cfg(accum=2)
    batches = [batch_of(cfg, seed=s) for s in range(4)]
    seen = []

    def record(stage, batch):
        seen.append(stage)
        return _scale_mel(stage, batch)
    obs = Observer(record)
    a = UnifiedTrainer(cfg, iter(batches), [batches[3]],
                       blocks=("acoustic", "refiner"), device="cpu",
                       observer=obs)
    moved = [_scale_mel("", as_tensors(b, "cpu")) for b in batches]
    b = UnifiedTrainer(cfg, iter(moved), [moved[3]],
                       blocks=("acoustic", "refiner"), device="cpu")
    ma = a.train_step(next(a.train_iter))
    mb = b.train_step(next(b.train_iter))
    ma.pop("step_time_s"), mb.pop("step_time_s")
    assert ma == mb
    assert seen == ["acoustic", "acoustic", "refiner"]
    assert a.validate() == b.validate()
    assert seen[3:] == ["acoustic", "refiner"] and obs.calls == 5
    for name in a.blocks:
        for (k, p), q in zip(a.blocks[name].model.state_dict().items(),
                             b.blocks[name].model.state_dict().values()):
            assert torch.equal(p, q), (name, k)


# -------------------------------------------------------- file-size gate
def test_check_file_sizes(tmp_path):
    from ttsx.utils.check_file_sizes import DEFAULT_LIMITS as J
    from ttsx_torch.utils.check_file_sizes import (DEFAULT_LIMITS,
                                                   check_file_sizes, main)
    assert DEFAULT_LIMITS == {k.replace("ttsx/", "ttsx_torch/"): v
                              for k, v in J.items()}
    assert check_file_sizes(REPO) == [] and main() == 0
    d = tmp_path / "ttsx_torch" / "eval"
    d.mkdir(parents=True)
    (d / "ok.py").write_text("x = 1\n\n" * 250)
    (d / "big.py").write_text("x = 1\n   \n" * 251)
    assert check_file_sizes(tmp_path) == [("ttsx_torch/eval/big.py", 251,
                                           250)]


# ----------------------------------------------------------- console scripts
def test_console_scripts_name_the_port():
    """Every ``ttsx-torch-*`` script imports and is callable, and each
    reference script has one, at the same function of the port's
    module."""
    import importlib
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    port = {k: v for k, v in scripts.items() if k.startswith("ttsx-torch-")}
    assert len(port) == 10
    for target in port.values():
        mod, attr = target.split(":")
        assert callable(getattr(importlib.import_module(mod), attr))
    for name, target in scripts.items():
        if name in port:
            continue
        twin = "ttsx-torch-" + name.removeprefix("ttsx-")
        assert port[twin] == target.replace("ttsx.", "ttsx_torch.", 1), name
