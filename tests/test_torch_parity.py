"""The parity harnesses of the port (``ttsx_torch/eval/parity*.py``,
``record_baseline.py``, ``rule_calibration.py``) and the last public
names it lacked, against ``ttsx`` on the CPU.

* The numpy helpers of ``parity_common`` (and ``_specaugment``,
  ``_pearson``, ``_interval_pr``) equal the reference's exactly;
  ``mel_energy_gain`` and ``_wav_quality`` on the same wavs within 1e-5
  relative (the mels run through torch and XLA; found: 1.8e-7 relative
  at most).
* ``disc_params`` at ``_tts_cfg()`` equals the reference's, counted from
  the modules (``jax.eval_shape`` of their init) with no training.
* ``rule_stability`` and ``tier_accuracy`` at the sizes of
  ``tests/test_pipeline.py::test_rule_calibration_harness`` give the
  reference's results and ``learned_confidences.json`` exactly.
* ``parity_aux.main`` with ``EXPERIMENTS`` stubbed in both packages
  writes the reference's results JSON; its ``p.error`` cases fail alike.
* The departures: a fully resumed ``acoustic_parity`` reports the loss
  its checkpoint stored (JSON without NaN); a GE2E run at batch 8 groups
  each utterance with its own speaker; the default outputs go to
  ``eval_results_torch/``, never ``eval_results/``; ``_device_mb`` is
  None on the CPU and raises when the card's memory cannot be read;
  ``TensorBoardLogger`` raises where ``torch.utils.tensorboard`` does not
  import.
* ``HarmonicSourceFilter`` (1e-5), ``FreqPosEmbed`` (exact),
  ``stochastic_depth`` (replayed draws, exact), ``BlockRegistry``,
  ``CSVLogger`` and ``TensorBoardLogger`` (their output exactly), and a
  walk of every reference module for its public names in the port.

Whole experiments against the reference are in
``tests/test_torch_parity_slow.py``.
"""
import ast
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import close, init_like, port, randn
from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------- parity_common
def _feats(seed=0, B=4, T=12, M=80):
    rng = np.random.default_rng(seed)
    return {"mel": rng.normal(size=(B, T, M)).astype(np.float32) - 3.0,
            "speaker_id": rng.integers(0, 3, B).astype(np.int32),
            "wav": rng.normal(size=(B, 64, 1)).astype(np.float32)}


@pytest.mark.parametrize("helper", ["speaker_vec", "normalize", "sampler",
                                    "specaugment", "pearson", "interval_pr"])
def test_numpy_helpers_equal_reference(helper):
    from ttsx.eval import parity_common as J
    from ttsx_torch.eval import parity_common as P
    d = _feats()
    if helper == "speaker_vec":
        for dim, n in ((16, 3), (2, 5)):
            np.testing.assert_array_equal(
                P._speaker_vec(d["speaker_id"], dim, n),
                J._speaker_vec(d["speaker_id"], dim, n))
    elif helper == "normalize":
        got, ref = P._normalize_mels(d), J._normalize_mels(d)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert P._model_batch(got).keys() == J._model_batch(ref).keys()
        from ttsx_torch.eval.metrics import mel_cepstral_distortion
        pred = randn(1, 12, 80)
        assert P._denorm_mcd(pred, got, 2, mel_cepstral_distortion) == \
            J._denorm_mcd(pred, ref, 2, mel_cepstral_distortion)
    elif helper == "sampler":
        sp, sj = P._batch_sampler(d, 3, 5), J._batch_sampler(d, 3, 5)
        for _ in range(3):
            a, b = next(sp), next(sj)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    elif helper == "specaugment":
        from ttsx.eval.parity_refenc import _specaugment as jspec
        from ttsx_torch.eval.parity_refenc import _specaugment
        m = d["mel"]
        np.testing.assert_array_equal(
            _specaugment(m, np.random.default_rng(3), 5, 4),
            jspec(m, np.random.default_rng(3), 5, 4))
    elif helper == "pearson":
        from ttsx.eval.parity_prosody import _pearson as jp
        from ttsx_torch.eval.parity_prosody import _pearson
        a, b = randn(1, 50), randn(2, 50)
        assert _pearson(a, b) == jp(a, b)
    else:
        from ttsx.eval.parity_diar import _interval_pr as jpr
        from ttsx_torch.eval.parity_diar import _interval_pr
        dets = [(0.0, 1.0), (2.0, 2.5), (4.0, 5.0)]
        truth = [(0.5, 0.7), (3.0, 3.5), (4.9, 6.0)]
        assert _interval_pr(dets, truth) == jpr(dets, truth)
        assert _interval_pr([], truth) == jpr([], truth)


@pytest.mark.parametrize("kind", ["tone", "formant", "formant_rich"])
def test_make_corpus_equals_reference(kind):
    from ttsx.eval.parity_common import make_corpus as J
    from ttsx_torch.eval.parity_common import AUDIO, make_corpus
    kw = dict(n_speakers=3, audio=AUDIO, seed=2, n_f0_groups=2,
              noise_db=12.0, intonation=0.2)
    pc, jc_ = make_corpus(kind, **kw), J(kind, **kw)
    assert type(pc).__name__ == type(jc_).__name__
    assert getattr(pc, "speaker_cues", None) == getattr(jc_, "speaker_cues",
                                                        None)
    for u, v in zip(pc.utterances(1, 8, seed=4), jc_.utterances(1, 8, seed=4)):
        np.testing.assert_array_equal(u.wav, v.wav)
        np.testing.assert_array_equal(u.phoneme_ids, v.phoneme_ids)
    for make in (make_corpus, J):
        with pytest.raises(ValueError, match="unknown corpus kind 'x'"):
            make("x")


def test_mel_energy_gain_and_wav_quality_match_reference():
    from ttsx.eval.parity_common import _wav_quality as jq
    from ttsx.eval.parity_common import mel_energy_gain as jg
    from ttsx_torch.eval.parity_common import (AUDIO, _wav_quality,
                                               mel_energy_gain)
    rng = np.random.default_rng(0)
    n = 8192
    tone = np.sin(2 * np.pi * 220 * np.arange(n) / 22050)
    real = (np.stack([tone, 0.5 * tone]) * 0.3
            + rng.normal(size=(2, n)) * 0.01).astype(np.float32)
    real[1, :3000] *= 1e-3                       # a quiet (unvoiced) stretch
    fake = (real * 0.7 + rng.normal(size=(2, n)) * 0.02).astype(np.float32)
    mel_req = rng.normal(size=(2, 33, 80)).astype(np.float32) - 4.0
    np.testing.assert_allclose(mel_energy_gain(fake, mel_req, AUDIO, "cpu"),
                               jg(fake, mel_req, AUDIO), rtol=1e-5)
    got, ref = _wav_quality(fake, real, "cpu"), jq(fake, real)
    assert got.keys() == ref.keys() and "wav_mcd_voiced_db" in ref
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


def test_disc_params_at_tts_cfg_match_reference():
    from ttsx.eval.parity import _tts_cfg as jcfg
    from ttsx.models import vocoder as JV
    from ttsx_torch.core.config import to_dict
    from ttsx_torch.eval.parity import _tts_cfg
    from ttsx_torch.models.discriminators import (MultiBandDiscriminator,
                                                  MultiPeriodDiscriminator,
                                                  MultiScaleDiscriminator)
    from ttsx.core.config import to_dict as jto_dict
    got = to_dict(_tts_cfg(3))
    ref = jto_dict(jcfg(3))
    assert got == {k: ref[k] for k in got}
    vc = _tts_cfg().vocoder
    jvc = jcfg().vocoder
    wav = jnp.zeros((1, 8192, 1))
    ref_n = sum(int(np.prod(leaf.shape)) for cls in (
        JV.MultiPeriodDiscriminator, JV.MultiScaleDiscriminator,
        JV.MultiBandDiscriminator) for leaf in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda c=cls: c(jvc).init(jax.random.PRNGKey(0),
                                                     wav))))
    n = sum(p.numel() for cls in (MultiPeriodDiscriminator,
                                  MultiScaleDiscriminator,
                                  MultiBandDiscriminator)
            for p in cls(vc).parameters())
    assert n == ref_n == 28_631_892


# ------------------------------------------------------- rule calibration
def test_rule_calibration_matches_reference(tmp_path):
    from ttsx.eval.rule_calibration import rule_stability as jr
    from ttsx.eval.rule_calibration import tier_accuracy as jt
    from ttsx_torch.eval.rule_calibration import (rule_stability,
                                                  tier_accuracy)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = tier_accuracy(n_segments=120, seed=1, work_dir=str(tmp_path / "p"))
    assert got == jt(n_segments=120, seed=1, work_dir=str(tmp_path / "j"))
    assert got["group_accuracy"] > 0.8 and got["ece"] < 0.15
    assert ((tmp_path / "p" / "learned_confidences.json").read_text()
            == (tmp_path / "j" / "learned_confidences.json").read_text())
    kw = dict(samples_per_rule=40, sigmas=(0.25,), max_draws=60_000)
    stab = rule_stability(**kw)
    assert stab == jr(**kw)
    assert stab["aggregate"]["rules_reachable"] == 31


# ------------------------------------------------------- parity_aux.main
def _stub_experiments(monkeypatch, module, calls):
    def make(name):
        def run(**kw):
            calls.append((name, kw.pop("device", None)))
            r = {"exp": name, "kw": kw, "_state": object()}
            if name == "refiner":
                r["acoustic"] = {"exp": "acoustic", "mcd_db": 1.5}
            return r
        return run
    monkeypatch.setattr(module, "EXPERIMENTS", {
        n: make(n) for n in module.EXPERIMENTS})


MAIN_CASES = {
    "all": [],
    "refiner": ["--exp", "refiner"],
    "flags": ["--exp", "vocoder_quality", "--steps", "7", "--save-dir", "sd",
              "--key", "vq_7", "--override", "scale_cond=true",
              "--override", "tag=abc", "--arg", "utts_train=64",
              "--arg", "corpus=formant"],
    "merge": ["--exp", "prosody", "--key", "acoustic"],
}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_parity_main_writes_the_reference_results(case, tmp_path,
                                                  monkeypatch):
    from ttsx.eval import parity_aux as J
    from ttsx_torch.eval import parity_aux as P
    outs = {}
    for tag, module in (("ref", J), ("port", P)):
        calls = []
        _stub_experiments(monkeypatch, module, calls)
        out = tmp_path / tag / "parity.json"
        out.parent.mkdir()
        out.write_text(json.dumps({"old": {"x": 1}, "acoustic": {"y": 2}}))
        assert module.main(["--out", str(out), "--cpu", *MAIN_CASES[case]]
                           ) == 0
        outs[tag] = (json.loads(out.read_text()), [c[0] for c in calls])
        if module is P:
            assert {c[1] for c in calls} == {"cpu"}
    assert outs["port"] == outs["ref"]
    if case == "all":
        assert outs["port"][1] == ["refenc", "prosody", "acoustic",
                                   "refiner", "vocoder", "diarizer"]


ERROR_CASES = [["--steps", "3"], ["--exp", "all", "--arg", "a=1"],
               ["--exp", "nope"]]


@pytest.mark.parametrize("argv", ERROR_CASES)
def test_parity_main_errors_like_reference(argv, tmp_path, monkeypatch,
                                           capsys):
    from ttsx.eval import parity_aux as J
    from ttsx_torch.eval import parity_aux as P
    msgs = []
    for module in (J, P):
        _stub_experiments(monkeypatch, module, [])
        with pytest.raises(SystemExit) as e:
            module.main(["--out", str(tmp_path / "r.json"), *argv])
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.splitlines()[-1].split(
            "error: ")[1])
    assert msgs[0] == msgs[1]


def test_parity_main_runs_on_the_card_unless_cpu(tmp_path, monkeypatch):
    from ttsx_torch.eval import parity_aux as P
    calls = []
    _stub_experiments(monkeypatch, P, calls)
    P.main(["--exp", "vocoder", "--out", str(tmp_path / "r.json")])
    assert calls == [("vocoder", "cuda")]
    monkeypatch.setattr(P, "EXPERIMENTS", {**P.EXPERIMENTS,
                                           "vocoder": P.vocoder_gan_smoke})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            P.main(["--exp", "vocoder", "--out", str(tmp_path / "r.json")])


# ------------------------------------------------------------ departures
def test_zoo_cfg_takes_a_zoo_json_overrides_as_given():
    """A zoo.json's ``vocoder_overrides`` apply as given, an empty set
    too (the reference's ``ttsx.zoo`` reads them so); None stands for the
    checked-in zoo's."""
    from ttsx.eval.parity import _tts_cfg as jcfg
    from ttsx_torch.core.config import zoo_cfg
    plain = zoo_cfg(True, {}).vocoder
    ref = jcfg().vocoder
    assert (plain.scale_cond, plain.lambda_energy) == (ref.scale_cond,
                                                       ref.lambda_energy)
    assert plain.use_pallas_upsample and plain.use_pallas_resblock_stack
    zoo = zoo_cfg(False).vocoder
    assert zoo.scale_cond and zoo.lambda_energy == 1.0
    assert zoo_cfg(False, {"scale_cond": True, "nope": 1}).vocoder.scale_cond


def test_default_outputs_leave_the_reference_records(tmp_path, monkeypatch):
    """``main`` of ``parity_aux``, ``rule_calibration`` and
    ``record_baseline`` without an output path write under
    ``eval_results_torch/`` and nothing under ``eval_results/``."""
    from ttsx_torch.eval import parity_aux, record_baseline
    from ttsx_torch.eval import rule_calibration as rc
    monkeypatch.chdir(tmp_path)
    _stub_experiments(monkeypatch, parity_aux, [])
    monkeypatch.setattr(rc, "rule_stability", lambda n: {"aggregate": {}})
    monkeypatch.setattr(rc, "tier_accuracy", lambda n: {
        "group_accuracy": 1.0, "ece": 0.0})
    monkeypatch.setattr(record_baseline, "record", lambda device: {
        "device": device})
    assert parity_aux.main(["--exp", "e2e", "--cpu"]) == 0
    assert rc.main([]) == 0
    assert record_baseline.main(["--cpu"]) == 0
    assert sorted(p.name for p in (tmp_path / "eval_results_torch").iterdir()
                  ) == ["parity.json", "results.json", "rule_calibration.json"]
    assert not (tmp_path / "eval_results").exists()


def test_fully_resumed_acoustic_reports_the_stored_loss(tmp_path):
    """A resumed run trains the steps left; a run whose checkpoint is at
    ``steps`` trains none and reports the loss the checkpoint stored
    (the reference reports NaN), so the record is JSON."""
    from ttsx_torch.eval.parity import acoustic_parity
    from ttsx_torch.train.checkpoint import read_meta
    kw = dict(n_speakers=2, utts_train=2, utts_eval=1, frames=16, batch=2,
              device="cpu", save_dir=str(tmp_path / "ck"))
    first = acoustic_parity(steps=1, **kw)
    assert read_meta(str(tmp_path / "ck"), "acoustic")["step"] == 1
    more = acoustic_parity(steps=2, **kw)
    meta = read_meta(str(tmp_path / "ck"), "acoustic")
    assert meta["step"] == 2 and meta["extra"]["loss"] == more["final_loss"]
    again = acoustic_parity(steps=2, **kw)
    assert again["final_loss"] == more["final_loss"]
    assert again["mcd_db"] == more["mcd_db"] != first["mcd_db"]
    json.dumps(again, allow_nan=False)


def test_ge2e_run_at_batch_8_groups_by_speaker(monkeypatch):
    """Every GE2E batch of ``refenc_parity`` at batch 8 is read by the
    loss as 2 speakers x 4 utterances, each group one speaker's."""
    from ttsx_torch.eval.parity_refenc import refenc_parity
    from ttsx_torch.train import losses
    seen = []
    real = losses.speaker_groups

    def groups(labels):
        n, m = real(labels)
        seen.append((labels.cpu().numpy().reshape(n, m), (n, m)))
        return n, m
    monkeypatch.setattr(losses, "speaker_groups", groups)
    res = refenc_parity(n_speakers=4, utts_train=2, utts_eval=1, frames=24,
                        steps=2, batch=8, loss="ge2e", device="cpu")
    assert res["loss_type"] == "ge2e" and np.isfinite(res["final_loss"])
    assert len(seen) == 2
    for lab, nm in seen:
        assert nm == (2, 4)
        assert (lab == lab[:, :1]).all() and len(set(lab[:, 0])) == 2


def test_device_mb_none_on_cpu_and_raises_on_a_failed_read(monkeypatch):
    from ttsx_torch.eval import record_baseline as R
    assert R._device_mb(torch.device("cpu")) is None

    def broken(dev=None):
        raise RuntimeError("no memory stats")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", broken)
    with pytest.raises(RuntimeError, match="no memory stats"):
        R._device_mb(torch.device("cuda"))


# ---------------------------------------------------- the leftover names
def test_harmonic_source_filter_and_freq_pos_embed_match_reference():
    from ttsx.nn.embed import FreqPosEmbed as JF
    from ttsx.nn.tf_block import HarmonicSourceFilter as JH
    from ttsx_torch.nn.embed import FreqPosEmbed
    from ttsx_torch.nn.tf_block import HarmonicSourceFilter
    x = randn(0, 2, 20, 24)
    jm = JH(channels=24, filt_ch=16)
    tree = init_like(jm, jnp.asarray(x), seed=1, scale=0.2)
    pm = port(HarmonicSourceFilter(24, 16), tree)
    close(pm(torch.as_tensor(x)), jm.apply(tree, jnp.asarray(x)), 1e-5, 1e-6)
    jf = JF(n_freq=12, dim=10)
    np.testing.assert_array_equal(FreqPosEmbed(12, 10)().numpy(),
                                  np.asarray(jf.apply({})))
    assert list(FreqPosEmbed(12, 10).state_dict()) == []


def test_stochastic_depth_matches_reference(monkeypatch):
    from torch_train_helpers import JaxDraws
    from ttsx.nn.film import stochastic_depth as jsd
    from ttsx_torch.nn.draws import ReplayDraws
    from ttsx_torch.nn.film import stochastic_depth
    x = randn(0, 16, 5, 3)
    draws = JaxDraws(monkeypatch)
    ref = jsd(jnp.asarray(x), 0.5, jax.random.PRNGKey(0), False)
    got = stochastic_depth(torch.as_tensor(x), 0.5, ReplayDraws(
        draws.records))
    close(got, ref, 0, 0)
    assert 0 < int((got[:, 0, 0] == 0).sum()) < 16
    close(stochastic_depth(torch.as_tensor(x), 0.5, None), x, 0, 0)
    close(stochastic_depth(torch.as_tensor(x), 0.0, draws), x, 0, 0)


def test_block_registry_matches_reference():
    from ttsx.train.engine import BlockRegistry as J
    from torch_train_helpers import tiny_cfg
    from ttsx_torch.train.blocks import AcousticBlock, RefinerBlock
    from ttsx_torch.train.engine import BlockRegistry
    assert set(BlockRegistry._registry) == set(J._registry) == {
        "acoustic", "refiner", "vocoder"}
    assert isinstance(BlockRegistry.create("acoustic", tiny_cfg(), "cpu"),
                      AcousticBlock)
    for reg in (BlockRegistry, J):
        with pytest.raises(KeyError, match="unknown train block 'gan'"):
            reg.create("gan", tiny_cfg())
    try:
        BlockRegistry.register("again")(RefinerBlock)
        assert isinstance(BlockRegistry.create("again", tiny_cfg(), "cpu",
                                               3), RefinerBlock)
    finally:
        BlockRegistry._registry.pop("again")


def _fake_trainer(step):
    return types.SimpleNamespace(state=types.SimpleNamespace(
        global_step=step))


def test_csv_logger_matches_reference(tmp_path):
    from ttsx.train.callbacks import CSVLogger as J
    from ttsx_torch.train.callbacks import CSVLogger
    texts = []
    for cls, name in ((J, "ref.csv"), (CSVLogger, "port.csv")):
        log = cls(str(tmp_path / "d" / name), every=2)
        for step in range(1, 6):
            log.on_step_end(_fake_trainer(step), {"loss": 0.5 / step,
                                                  "lr": 1e-3, "extra": step})
        texts.append((tmp_path / "d" / name).read_text())
    assert texts[0] == texts[1] and texts[0].count("\n") == 3


class _Writer:
    def __init__(self, logdir):
        self.logdir, self.calls = logdir, []

    def add_scalar(self, *a):
        self.calls.append(a)


def test_tensorboard_logger_matches_reference(monkeypatch, tmp_path):
    """The same scalars as the reference's; where
    ``torch.utils.tensorboard`` does not import the port's raises and the
    reference's writes nothing."""
    from ttsx.train.callbacks import TensorBoardLogger as J
    from ttsx_torch.train.callbacks import TensorBoardLogger
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=_Writer))
    calls = []
    for cls in (J, TensorBoardLogger):
        log = cls(str(tmp_path), every=2)
        for step in (1, 2):
            log.on_step_end(_fake_trainer(step), {"loss": 0.25, "n": 3,
                                                  "s": "x"})
        log.on_validation_end(_fake_trainer(2), {"l1": 0.5})
        calls.append(log.writer.calls)
    assert calls[0] == calls[1] == [("loss", 0.25, 2), ("n", 3, 2),
                                    ("val/l1", 0.5, 2)]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert J(str(tmp_path)).writer is None
    with pytest.raises(ImportError):
        TensorBoardLogger(str(tmp_path))


# names the walk exempts: each a departure, with where the port has it
DEPARTURES = {
    "core/mesh.py": {n: "SPMD, one process per rank (core/mesh.py)" for n in
                     ("batch_sharding", "replicated_sharding",
                      "maybe_constrain")},
    "eval/export.py": {"export_stablehlo": "export_pt2 (a .pt2 program)",
                       "load_stablehlo": "load_pt2"},
    "models/vocoder.py": {n: "models/discriminators.py" for n in (
        "PeriodDiscriminator", "ScaleDiscriminator",
        "BandDiscriminatorTower", "MultiPeriodDiscriminator",
        "MultiScaleDiscriminator", "MultiBandDiscriminator",
        "LearnableSTFT", "STFTLoss")},
    "native/__init__.py": {n: "built at first use and loaded by path: "
                              "native.try_load / native.load" for n in (
                                  "prefetch", "wavio")},
    "nn/conv.py": {"PallasUpsample": "K1 behind the generator's "
                                     "ConvTranspose1d (ops/upsample.py)"},
    "train/blocks.py": {"VocoderStates": "VocoderBlock.states"},
    "train/losses.py": {"nn_relu": "torch.relu"},
    "train/optim.py": {"adamw": "make_optimizer / ClippedAdamW"},
}


def _top_level_names(path: Path, imported: bool = False):
    """The public names a module's source binds at its top level (inside
    top-level ``if`` / ``try`` blocks too, but the ``__main__`` guard):
    defs, classes, assignments,
    and with ``imported`` its imports. Read from the source: importing a
    submodule would rebind a package attribute of the same name
    (``ttsx_torch.native.build``, the module, over the function)."""
    names = set()

    def walk(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                names.add(node.target.id)
            elif imported and isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in node.names)
            elif isinstance(node, ast.Try) or isinstance(
                    node, ast.If) and "__main__" not in ast.unparse(node.test):
                walk(node.body)
                walk(getattr(node, "orelse", []))
                for h in getattr(node, "handlers", []):
                    walk(h.body)
    walk(ast.parse(path.read_text()).body)
    return {n for n in names if not n.startswith("_")}


def test_every_reference_name_has_its_port():
    """Each module of ``ttsx`` but the Pallas kernels' (``ops/*_kernel``,
    whose ports are ``ops/*.py`` under other names) has its port, and each
    public top-level name it defines is in the port's module, but the
    departures named above, each where the port has it."""
    missing, extra = [], []
    for f in sorted((REPO / "ttsx").rglob("*.py")):
        rel = f.relative_to(REPO / "ttsx").as_posix()
        if rel.startswith("ops/") and rel != "ops/__init__.py":
            continue
        assert (REPO / "ttsx_torch" / rel).exists(), rel
        have = _top_level_names(REPO / "ttsx_torch" / rel, imported=True)
        exempt = DEPARTURES.get(rel, {})
        missing += [f"{rel}::{n}" for n in sorted(_top_level_names(f))
                    if n not in exempt and n not in have]
        extra += [f"{rel}::{n}" for n in exempt if n in have]
    assert missing == [] and extra == []
    from ttsx_torch.models import discriminators
    for n in DEPARTURES["models/vocoder.py"]:
        assert hasattr(discriminators, n), n
