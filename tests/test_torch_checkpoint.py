"""Checkpoints and ``--resume`` in the port, against ``ttsx`` on the CPU.

* every block's full state round-trips exactly, and a checkpoint that
  does not fit the trainer is refused whole;
* a run of the three blocks stopped at step 2 and resumed from ``last``
  equals an uninterrupted run bit for bit (parameters, moments, counts,
  update steps, the EMA, generator states, the run's state);
* the engine writes the same tags at the same global steps as the
  reference's engine on the same cadence, with the reference's
  ``meta.json`` keys;
* the three reference behaviours the port departs from, each pinned:
  (a) the reference's ``--resume`` restores before its states exist and
  raises, (b) its ``main_synth --checkpoint`` restores the engine's tree
  into the pipeline's and raises, (c) its ``extra`` drops the GAN loss
  EMAs;
* ``main_train --resume`` and ``main_synth --checkpoint`` on the CPU;
  a resumed ``main_train`` goes on with the batches that follow the
  stopped run's (a departure: the reference starts its stream again from
  the seed);
* the acoustic and refiner slim exports, both ways, exact.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from torch_parity_helpers import init_like
from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_train_helpers import _numpy, gan_cfg, jax_cfg, tiny_cfg

from ttsx_torch.core import config as tc
from ttsx_torch.train import checkpoint as ckpt

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCRIPTED_VAL = [3.0, 2.0, 2.5, 1.0, 1.5]
# (tag, global step) of each save in 5 steps, validation every step on
# SCRIPTED_VAL, checkpoint_freq 2
CADENCE = [("best", 1), ("best", 2), ("last", 2), ("best", 4), ("last", 4),
           ("final", 5)]


def with_train(cfg, **kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **kw))


def script_validation(trainer, values):
    """``trainer.validate`` returns ``values`` in turn, keeping ``best_val``
    as the engines do."""
    it = iter(values)

    def validate():
        v = next(it)
        m = {"val_l1": v}
        if v < trainer.state.best_val:
            trainer.state.best_val = v
            m["best"] = True
        return m
    trainer.validate = validate


def record_saves(monkeypatch, module):
    saves = []
    save = module.save_checkpoint

    def recording(directory, tag, states, step, extra=None):
        saves.append((tag, int(step)))
        return save(directory, tag, states, step, extra)
    monkeypatch.setattr(module, "save_checkpoint", recording)
    return saves


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference engine (acoustic block) for 5 steps on the scripted
    cadence; returns its checkpoint directory, the saves and the
    config."""
    import ttsx.train.checkpoint as jckpt
    from ttsx.data.synthetic import synthetic_stream
    from ttsx.train.engine import UnifiedTrainer as JTrainer
    cfg = with_train(tiny_cfg(), val_freq=1, checkpoint_freq=2, max_steps=5)
    d = tmp_path_factory.mktemp("ref")
    mp = pytest.MonkeyPatch()
    saves = record_saves(mp, jckpt)
    try:
        jcfg = jax_cfg(cfg)
        jt = JTrainer(jcfg, synthetic_stream(jcfg, 2, 4, n=5),
                      blocks=("acoustic",), checkpoint_dir=str(d))
        script_validation(jt, SCRIPTED_VAL)
        jt.train()
    finally:
        mp.undo()
    return d, saves, cfg, jt


# ------------------------------------------------------------ the format
def test_every_block_state_round_trips_exactly(tmp_path):
    """Three blocks after a step (moments, counts, EMA, VQ statistics and
    generator states all past their start) into a trainer built from
    another seed: every entry equal, dtype kept; the run's state too."""
    from ttsx_torch.data.synthetic import synthetic_stream
    from ttsx_torch.train.engine import UnifiedTrainer
    cfg = gan_cfg()
    a = UnifiedTrainer(cfg, synthetic_stream(cfg, 2, 8, n=1), device="cpu",
                       checkpoint_dir=str(tmp_path))
    a.train(max_steps=1)
    a.state.d_loss_ema, a.state.best_val = 1.7, 0.25
    a.save_checkpoint("last")
    b = UnifiedTrainer(with_train(cfg, seed=7), [], device="cpu",
                       checkpoint_dir=str(tmp_path))
    before = ckpt.flatten(b.block_states)
    want = ckpt.flatten(a.block_states)
    assert any(not torch.equal(before[k], want[k]) for k in want)
    assert b.restore_checkpoint("last")
    got = ckpt.flatten(b.block_states)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    parts = ("gen", "gst", "mpd", "msd", "mbd", "stft")
    kinds = {k.split("/")[2] if k.split("/")[1] in parts else k.split("/")[1]
             for k in want}
    assert {"params", "opt", "step", "ema", "rng"} <= kinds
    assert any("vq" in k for k in want)
    assert "vocoder/stft/params/stft_512.filterbank" in want
    assert b.state.global_step == 1
    assert (b.state.d_loss_ema, b.state.best_val) == (1.7, 0.25)
    assert not b.restore_checkpoint("best")
    assert not UnifiedTrainer(cfg, [], device="cpu").restore_checkpoint()


def test_mismatched_checkpoints_are_refused_whole(tmp_path):
    from ttsx_torch.train.engine import UnifiedTrainer
    cfg = tiny_cfg()
    a = UnifiedTrainer(cfg, [], device="cpu", blocks=("acoustic",),
                       checkpoint_dir=str(tmp_path))
    a.save_checkpoint("last")
    wide = dataclasses.replace(cfg, acoustic=dataclasses.replace(
        cfg.acoustic, hidden_channels=24))
    b = UnifiedTrainer(wide, [], device="cpu", blocks=("acoustic",),
                       checkpoint_dir=str(tmp_path))
    before = ckpt.flatten(b.block_states)
    before = {k: v.clone() for k, v in before.items()}
    with pytest.raises(ckpt.CheckpointMismatch, match="shape or dtype"):
        b.restore_checkpoint("last")
    after = ckpt.flatten(b.block_states)
    assert all(torch.equal(before[k], after[k]) for k in before)
    c = UnifiedTrainer(cfg, [], device="cpu", blocks=("acoustic", "refiner"),
                       checkpoint_dir=str(tmp_path))
    with pytest.raises(ckpt.CheckpointMismatch, match="missing.*refiner/"):
        c.restore_checkpoint("last")
    # a save cut short before its meta.json restores as absent
    (tmp_path / "last" / "meta.json").unlink()
    assert ckpt.read_checkpoint(str(tmp_path), "last") is None


# ---------------------------------------------------- resume is exact
def test_resumed_run_equals_uninterrupted_run(tmp_path):
    """Three blocks on ``gan_cfg()``: 3 steps straight, against 1 step,
    ``last`` at step 1, a fresh trainer restored from it and steps 2-3 on
    the batches that follow (the refiner's second update, at step 3, and
    the discriminators' first without R1 run after the restore). Every
    entry of the state bitwise equal; the run's state (the GAN loss EMAs
    included) equal."""
    from ttsx_torch.data.synthetic import synthetic_stream
    from ttsx_torch.train.engine import UnifiedTrainer
    cfg = with_train(gan_cfg(), checkpoint_freq=1)
    batches = list(synthetic_stream(cfg, batch=2, frames=8, n=3))
    a = UnifiedTrainer(cfg, iter(batches), device="cpu")
    a.train(max_steps=3)
    b = UnifiedTrainer(cfg, iter(batches), device="cpu",
                       checkpoint_dir=str(tmp_path))
    b.train(max_steps=1)
    c = UnifiedTrainer(cfg, iter(batches[1:]), device="cpu",
                       checkpoint_dir=str(tmp_path))
    assert c.restore_checkpoint("last") and c.state.global_step == 1
    c.train(max_steps=3)
    assert c.blocks["refiner"].state.step == 2
    want, got = ckpt.flatten(a.block_states), ckpt.flatten(c.block_states)
    assert got.keys() == want.keys()
    assert [k for k in want if not torch.equal(got[k], want[k])] == []
    for k in ("global_step", "best_val", "noise_scale", "l1_weight",
              "d_loss_ema", "g_loss_ema"):
        assert getattr(c.state, k) == getattr(a.state, k), k
    assert a.state.d_loss_ema != 1.0


# ------------------------------------------------------ the cadence
def test_engine_cadence_matches_reference(reference_run, tmp_path,
                                          monkeypatch):
    """Validation every step on scripted values, ``checkpoint_freq`` 2, 5
    steps: both engines save ``best``, ``last`` and ``final`` at the same
    global steps, call ``on_checkpoint`` after each save, and write
    ``meta.json`` with the reference's keys (the port's ``extra`` a
    superset of the reference's)."""
    from ttsx_torch.data.synthetic import synthetic_stream
    from ttsx_torch.train.callbacks import Callback
    from ttsx_torch.train.engine import UnifiedTrainer
    ref_dir, ref_saves, cfg, _ = reference_run
    saves = record_saves(monkeypatch, ckpt)
    calls = []

    class Seen(Callback):
        def on_checkpoint(self, trainer, step):
            calls.append((saves[-1], step))

    pt = UnifiedTrainer(cfg, synthetic_stream(cfg, 2, 4, n=5), device="cpu",
                        blocks=("acoustic",), checkpoint_dir=str(tmp_path),
                        callbacks=[Seen()])
    script_validation(pt, SCRIPTED_VAL)
    pt.train()
    assert ref_saves == saves == CADENCE
    assert calls == [(s, s[1]) for s in CADENCE]
    for tag in ("best", "last", "final"):
        ref = json.loads((ref_dir / tag / "meta.json").read_text())
        got = json.loads((tmp_path / tag / "meta.json").read_text())
        assert set(got) == set(ref) == {"step", "extra"}
        assert got["step"] == ref["step"]
        assert set(ref["extra"]) < set(got["extra"])
        assert {k: got["extra"][k] for k in ref["extra"]} == ref["extra"]


# ------------------------------------- reference behaviours not copied
def test_reference_resume_raises_before_init(reference_run):
    """(a) The reference's ``main_train --resume`` calls
    ``restore_checkpoint("last")`` on a trainer whose block states do not
    exist until ``train()`` builds them: the restore into the empty tree
    raises. The port's blocks exist from construction on, so its
    ``--resume`` restores (see
    ``test_main_train_resume_and_main_synth_checkpoint``)."""
    from ttsx.train.engine import UnifiedTrainer as JTrainer
    ref_dir, _, cfg, _ = reference_run
    jt = JTrainer(jax_cfg(cfg), iter([]), blocks=("acoustic",),
                  checkpoint_dir=str(ref_dir))
    with pytest.raises(ValueError, match="do not match"):
        jt.restore_checkpoint("last")


def test_reference_synth_checkpoint_tree_does_not_restore(reference_run):
    """(b) The reference's ``main_synth --checkpoint`` restores the
    engine's ``best`` (block states keyed acoustic / refiner / vocoder)
    into the pipeline's parameter tree (acoustic / refiner / generator /
    gst): the trees differ and the restore raises. The port maps the
    blocks' modules onto the pipeline's (``load_pipeline_checkpoint``)."""
    from ttsx.models.pipeline import TTSPipeline
    from ttsx.train.checkpoint import restore_checkpoint
    ref_dir, _, cfg, _ = reference_run
    pipe = TTSPipeline(jax_cfg(cfg))
    shapes = jax.eval_shape(lambda: pipe.init_params(jax.random.PRNGKey(0),
                                                     batch=1, frames=8))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    shapes)
    with pytest.raises(ValueError, match="do not match"):
        restore_checkpoint(str(ref_dir), "best", params)


def test_reference_extra_drops_the_gan_loss_emas(reference_run, tmp_path):
    """(c) The reference's ``extra`` holds ``best_val``, ``noise_scale``
    and ``l1_weight`` only, so a restored trainer starts its dynamic-GAN
    loss EMAs again from 1.0; the port saves and restores them."""
    from ttsx.data.synthetic import synthetic_batch
    from ttsx.train.engine import UnifiedTrainer as JTrainer
    from ttsx_torch.train.engine import UnifiedTrainer
    ref_dir, _, cfg, jt = reference_run
    meta = json.loads((ref_dir / "final" / "meta.json").read_text())
    assert set(meta["extra"]) == {"best_val", "noise_scale", "l1_weight"}
    jt.state.d_loss_ema, jt.state.g_loss_ema = 1.7, 0.6
    jt.checkpoint_dir = str(tmp_path / "ref")
    jt.save_checkpoint("last")
    jcfg = jax_cfg(cfg)
    j2 = JTrainer(jcfg, iter([]), blocks=("acoustic",),
                  checkpoint_dir=str(tmp_path / "ref"))
    j2.init_states(synthetic_batch(jcfg, 2, 4, with_wav=False))
    assert j2.restore_checkpoint("last")
    assert (j2.state.d_loss_ema, j2.state.g_loss_ema) == (1.0, 1.0)
    pt = UnifiedTrainer(cfg, [], device="cpu", blocks=("acoustic",),
                        checkpoint_dir=str(tmp_path / "port"))
    pt.state.d_loss_ema, pt.state.g_loss_ema = 1.7, 0.6
    pt.save_checkpoint("last")
    p2 = UnifiedTrainer(cfg, [], device="cpu", blocks=("acoustic",),
                        checkpoint_dir=str(tmp_path / "port"))
    assert p2.restore_checkpoint("last")
    assert (p2.state.d_loss_ema, p2.state.g_loss_ema) == (1.7, 0.6)


# ------------------------------------------------------------------ CLI
def test_main_train_resume_and_main_synth_checkpoint(tmp_path, capsys):
    """``main_train`` for 1 step (``last`` at 1), then ``--resume`` to 2:
    it starts at step 2 and ``final`` is step 2. ``main_synth
    --checkpoint`` then synthesizes with the run's ``best``: the acoustic
    and refiner models and the generator's EMA and GST of that save."""
    from ttsx_torch.cli.main import main_synth, main_train
    from ttsx_torch.models.pipeline import TTSPipeline
    cfg = with_train(gan_cfg(), val_freq=1, checkpoint_freq=1)
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps(tc.to_dict(cfg)))
    out = tmp_path / "out"
    args = ["--synthetic", "--device", "cpu", "--config", str(cfg_file),
            "--output-dir", str(out)]
    assert main_train(args + ["--max-steps", "1"]) == 0
    assert main_train(args + ["--max-steps", "2", "--resume"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["global_step"] == 2
    log = [json.loads(l) for l in (out / "train_log.jsonl").read_text()
           .splitlines()]
    assert [r["step"] for r in log if "val" not in r] == [1, 2]
    ck = out / "checkpoints"
    assert json.loads((ck / "final" / "meta.json").read_text())["step"] == 2
    flat, step, _ = ckpt.read_checkpoint(str(ck), "best")

    wav = tmp_path / "x.wav"
    assert main_synth(["--device", "cpu", "--config", str(cfg_file),
                       "--frames", "8", "--out", str(wav), "--checkpoint",
                       str(ck)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["checkpoint"] == {"tag": "best", "step": step, "stages": [
        "acoustic", "generator", "gst", "refiner"]}
    assert line["samples"] == 8 * cfg.vocoder.hop_length
    pipe = TTSPipeline(cfg)
    ckpt.load_pipeline_checkpoint(pipe, str(ck))
    for name, module in (("acoustic", pipe.acoustic),
                         ("refiner", pipe.refiner)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, flat[f"{name}/params/{k}"]), k
    gen = pipe.generator.state_dict()
    names = {n for n, _ in pipe.generator.named_parameters()}
    for k, v in gen.items():
        src = "ema" if k in names else "params"
        assert torch.equal(v, flat[f"vocoder/gen/{src}/{k}"]), k
    assert any(not torch.equal(flat[f"vocoder/gen/ema/{k}"],
                               flat[f"vocoder/gen/params/{k}"]) for k in names)


def _wav_tree(root):
    from ttsx_torch.data.dataset import write_wav
    rng = np.random.default_rng(0)
    for i in range(6):
        d = root / f"spk{i % 2}" / "read" / f"s{i % 3}"
        d.mkdir(parents=True, exist_ok=True)
        n = int(rng.integers(3000, 9000))
        write_wav(d / f"u{i}.wav", (0.3 * np.sin(np.arange(n) * 0.05 * (i + 1))
                                    ).astype(np.float32), 16000)
        (d / f"u{i}.txt").write_text(f"utterance number {i}")
    return str(root)


@pytest.mark.parametrize("source", ["wav_tree", "synthetic"])
def test_resumed_main_train_continues_the_data_stream(source, tmp_path,
                                                      monkeypatch, capsys):
    """``main_train`` (acoustic block, 2 micro-batches a step) for 2 steps,
    then ``--resume`` to 4, sees the batches of 4 uninterrupted steps: the
    collator's items and ``batch_idx``, or the synthetic batches' seeds,
    in order, and ends with the same parameters and moments, bitwise (the
    collator's cache keeps each wav's first augmentation, which the
    resumed stream replays). The reference's ``--resume`` draws batches
    0, 1, ... again."""
    import ttsx_torch.data.collate as collate
    import ttsx_torch.data.synthetic as synthetic
    from ttsx_torch.cli.main import main_train
    seen = []
    call, batch = collate.TTSCollator.__call__, synthetic.synthetic_batch

    def collating(self, items, epoch=0, batch_idx=0):
        if self.cfg.augment:    # the training collator, not validation's
            seen.append(([it["wav_path"] for it in items], batch_idx))
        return call(self, items, epoch, batch_idx)

    def drawing(cfg, *args, seed=0, **kw):
        if seed != 10_000:      # the validation batch
            seen.append(seed)
        return batch(cfg, *args, seed=seed, **kw)
    monkeypatch.setattr(collate.TTSCollator, "__call__", collating)
    monkeypatch.setattr(synthetic, "synthetic_batch", drawing)
    cfg = with_train(tiny_cfg(accum=2), checkpoint_freq=2)
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps(tc.to_dict(cfg)))
    data = (["--data-root", _wav_tree(tmp_path / "wavs")]
            if source == "wav_tree" else ["--synthetic"])
    runs = {}
    for name, legs in (("straight", [(["--max-steps", "4"], 8)]),
                       ("resumed", [(["--max-steps", "2"], 4),
                                    (["--max-steps", "4", "--resume"], 4)])):
        used = []
        out = tmp_path / name
        for leg, n in legs:
            seen.clear()
            assert main_train(data + leg + [
                "--device", "cpu", "--config", str(cfg_file), "--blocks",
                "acoustic", "--output-dir", str(out)]) == 0
            used += seen[:n]    # a wav stream collates one batch ahead
        runs[name] = (used, ckpt.read_checkpoint(str(out / "checkpoints"),
                                                 "final"))
    capsys.readouterr()
    (want, (flat_a, step_a, extra_a)), (got, (flat_b, step_b, extra_b)) = (
        runs["straight"], runs["resumed"])
    assert got == want
    assert [b if source == "synthetic" else b[1] for b in got] == list(
        range(8))
    assert step_a == step_b == 4 and extra_a == extra_b
    assert extra_b["batches"] == 8
    assert flat_a.keys() == flat_b.keys()
    assert [k for k in flat_a if not torch.equal(flat_a[k], flat_b[k])] == []


# ------------------------------------------------------------ slim exports
@pytest.mark.parametrize("name", ["acoustic", "refiner"])
def test_slim_export_both_ways(name, tmp_path):
    """``save_slim_npz(path, {name: to_flax(model)})`` read back by
    ``ttsx.train.slim_export.load_slim`` and by the port, and the
    reference's ``save_slim`` of a tree read by the port: equal leaf for
    leaf to the values as stored (float16 for leaves of 1024 values or
    more)."""
    from ttsx.models.acoustic import AcousticModel as JA
    from ttsx.models.refiner import ScoreSDERefiner as JR
    from ttsx.train.slim_export import load_slim, save_slim
    from ttsx_torch.models.acoustic import AcousticModel
    from ttsx_torch.models.refiner import ScoreSDERefiner
    from ttsx_torch.nn.init import fresh_init_
    from ttsx_torch.weights import (F16_MIN_SIZE, from_flax, load_flax,
                                    load_slim_npz, save_slim_npz, to_flax)
    from torch_train_helpers import batch_of
    cfg = tiny_cfg()
    jcfg = jax_cfg(cfg)
    b = {k: jax.numpy.asarray(v) for k, v in batch_of(cfg).items()}
    if name == "acoustic":
        model = AcousticModel(cfg.acoustic)
        template = init_like(JA(jcfg.acoustic), b["text_emb"], b["prosody"],
                             b["emotion_probs"], target_mel=b["mel"],
                             speaker=b["speaker"])
    else:
        model = ScoreSDERefiner(cfg.refiner, cfg.acoustic.text_emb_dim,
                                cfg.acoustic.cond_dim)
        template = init_like(JR(jcfg.refiner), b["mel"], b["prosody"],
                             b["style_id"], b["text_emb"])
    template = _numpy(template)
    fresh_init_(model, torch.Generator().manual_seed(3))
    tree = to_flax(model)
    assert set(tree) == ({"params", "vq_stats"} if name == "refiner"
                         else {"params"})
    path = str(tmp_path / f"{name}.npz")
    save_slim_npz(path, {name: tree})
    ref = load_slim(path, {name: template})[name]
    mine = load_slim_npz(path)[name]
    stored = jax.tree_util.tree_map(
        lambda a: (a.astype(np.float16).astype(np.float32)
                   if a.dtype == np.float32 and a.size >= F16_MIN_SIZE else a),
        tree)
    for got in (ref, mine):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(stored))
        assert len(flat_got) == len(flat_want)
        for kp, leaf in flat_got:
            np.testing.assert_array_equal(np.asarray(leaf), flat_want[kp])
    # the reference's export read by the port
    jpath = str(tmp_path / f"{name}_ref.npz")
    save_slim(jpath, {name: template})
    port_model = load_flax(type(model)(*(
        (cfg.acoustic,) if name == "acoustic" else
        (cfg.refiner, cfg.acoustic.text_emb_dim, cfg.acoustic.cond_dim))),
        load_slim_npz(jpath)[name])
    want = from_flax(model, load_slim(jpath, {name: template})[name])
    for k, v in port_model.state_dict().items():
        assert torch.equal(v, want[k]), k
