"""The port's ``UnifiedTrainer`` and ``main_train`` against ``ttsx`` on the
CPU (same weights, same draws: see torch_train_helpers.py), the two
reference defects the engine does not copy, and a fresh block's init."""
import json

import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_train_helpers import (JaxDraws, batch_of, close_metrics, gan_cfg,
                                 jax_cfg, seed_block_init, tiny_cfg)

from ttsx_torch.core import config as tc
from ttsx_torch.nn.draws import ReplayDraws
from ttsx_torch.weights import load_flax

# torch on one thread: six workers share the cores (torch_parity_helpers)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


# -------------------------------------------------------------------- engine
def test_unified_trainer_parity_without_accumulation(monkeypatch):
    """``UnifiedTrainer`` at grad_accum_steps=1, refiner every 2nd step:
    3 engine steps with a validation between the 2nd and the 3rd (noise
    scale and L1 weight annealed from the validation L1), every step
    metric and the validation against the reference engine."""
    from ttsx.train.engine import UnifiedTrainer as JTrainer
    from ttsx_torch.train.engine import UnifiedTrainer
    cfg = tiny_cfg()
    batches = [batch_of(cfg, seed=s) for s in range(3)]
    val = [batch_of(cfg, seed=9)]
    jt = JTrainer(jax_cfg(cfg), iter(batches), val_iter=val,
                  blocks=("acoustic", "refiner"))
    pt = UnifiedTrainer(cfg, iter(batches), val, device="cpu",
                        blocks=("acoustic", "refiner"))
    for i, name in enumerate(("acoustic", "refiner")):
        load_flax(pt.blocks[name].model,
                  seed_block_init(name, jt.blocks[name], batches[0], i))
    jt.init_states(batches[0])
    draws = JaxDraws(monkeypatch)
    for name in ("acoustic", "refiner"):
        jblock = jt.blocks[name]
        jblock.train_step = (lambda f, n: lambda *a: draws.call(n, f, *a)[0])(
            jblock.train_step, name)
    for step in range(3):
        if step == 2:
            close_metrics(pt.validate(), jt.validate())
            assert pt.state.noise_scale == pytest.approx(
                jt.state.noise_scale, rel=1e-6)
            assert pt.state.l1_weight == pytest.approx(jt.state.l1_weight,
                                                       rel=1e-6)
        ref = jt.train_step(batches[step])
        for name in pt.blocks:
            pt.blocks[name].state.draws = ReplayDraws(draws.last[name])
        got = pt.train_step(batches[step])
        ref.pop("step_time_s"), got.pop("step_time_s")
        close_metrics(got, ref)
        assert ("refiner/loss" in got) == (step % 2 == 0)
    assert pt.state.global_step == jt.state.global_step == 3


def test_engine_trains_on_unequal_buckets():
    """Reference defect the port does not copy: with grad_accum_steps=2 two
    micro-batches of different bucket lengths (8 and 16 frames) make one
    update in the port; the reference stacks them and raises."""
    from ttsx.train.engine import UnifiedTrainer as JTrainer
    from ttsx_torch.train.engine import UnifiedTrainer
    cfg = tiny_cfg(accum=2)
    batches = [batch_of(cfg, seed=0, frames=8), batch_of(cfg, seed=1,
                                                         frames=16)]
    pt = UnifiedTrainer(cfg, iter(batches[1:]), device="cpu",
                        blocks=("acoustic", "refiner"))
    m = pt.train_step(batches[0])
    assert np.isfinite(m["acoustic/loss"]) and np.isfinite(m["refiner/loss"])
    assert pt.blocks["acoustic"].state.step == 1
    jt = JTrainer(jax_cfg(cfg), iter(batches[1:]), blocks=("acoustic",))
    seed_block_init("acoustic", jt.blocks["acoustic"], batches[0], 0)
    jt.init_states(batches[0])
    with pytest.raises((ValueError, TypeError)):
        jt.train_step(batches[0])


def test_engine_pairs_refiner_with_micro_batch_zero():
    """Reference defect the port does not copy: under accumulation the
    refiner trains on micro-batch 0 and the acoustic prediction *for that
    micro-batch* (the reference hands it the last micro-batch's)."""
    from ttsx_torch.train.engine import UnifiedTrainer
    cfg = tiny_cfg(accum=2)
    batches = [batch_of(cfg, seed=s) for s in (0, 1)]
    pt = UnifiedTrainer(cfg, iter(batches[1:]), device="cpu",
                        blocks=("acoustic", "refiner"))
    seen = {}
    ac, rf = pt.blocks["acoustic"], pt.blocks["refiner"]
    accum, refine = ac.train_step_accum, rf.train_step

    def spy_accum(micro):
        seen["accum"] = out = accum(micro)
        return out

    def spy_refine(batch, mel_pred, *a):
        seen["batch"], seen["mel_pred"] = batch, mel_pred
        return refine(batch, mel_pred, *a)

    ac.train_step_accum, rf.train_step = spy_accum, spy_refine
    pt.train_step(batches[0])
    mels = seen["accum"]["mel_pred"]
    assert seen["mel_pred"] is mels[0]
    assert not torch.allclose(mels[0], mels[1])
    np.testing.assert_array_equal(seen["batch"]["mel"].numpy(),
                                  batches[0]["mel"])


# ---------------------------------------------------------------- entry point
def _cfg_file(tmp_path, cfg):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(tc.to_dict(cfg)))
    return str(path)


def test_main_train_synthetic_on_cpu(tmp_path, capsys):
    """Acoustic + refiner on synthetic batches (3 steps, a validation);
    then acoustic + vocoder for 2 steps at the tiny vocoder, which trains
    the GAN each step."""
    from ttsx_torch.cli.main import main_train
    out = tmp_path / "out"
    rc = main_train(["--synthetic", "--device", "cpu", "--max-steps", "3",
                     "--config", _cfg_file(tmp_path, tiny_cfg(accum=2)),
                     "--blocks", "acoustic,refiner",
                     "--output-dir", str(out)])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["global_step"] == 3 and np.isfinite(res["val_l1"])
    assert res["noise_scale"] == pytest.approx(np.clip(res["val_l1"], .05, 1))
    log = [json.loads(l) for l in (out / "train_log.jsonl").read_text()
           .splitlines()]
    assert [r["step"] for r in log] == [1, 2, 3, 3]
    assert "val" in log[-1] and "refiner/loss" in log[0]
    assert json.loads((out / "step_times.json").read_text())["steps"] == 3
    voc = tmp_path / "voc"
    rc = main_train(["--synthetic", "--device", "cpu", "--max-steps", "2",
                     "--config", _cfg_file(tmp_path, gan_cfg()),
                     "--blocks", "acoustic,vocoder", "--output-dir", str(voc)])
    assert rc == 0
    log = [json.loads(l) for l in (voc / "train_log.jsonl").read_text()
           .splitlines()]
    steps = [r for r in log if "vocoder/g_loss" in r]
    assert len(steps) == 2 and all(np.isfinite(r["vocoder/d_loss"])
                                   for r in steps)


def test_main_train_on_a_wav_tree_on_cpu(tmp_path, capsys):
    """The trainer's path at a tiny size: wav tree -> dataset -> collator
    (K3's plain version on the CPU) -> adapter -> the three blocks (the
    vocoder on the collated wav, cut to whole generator hops) ->
    validation."""
    from ttsx.data.dataset import write_wav
    from ttsx_torch.cli.main import main_train
    rng = np.random.default_rng(0)
    for i in range(6):
        d = tmp_path / "wavs" / f"spk{i % 2}" / "read" / f"s{i % 3}"
        d.mkdir(parents=True, exist_ok=True)
        n = int(rng.integers(3000, 9000))
        write_wav(d / f"u{i}.wav", (0.3 * np.sin(np.arange(n) * 0.05 * (i + 1))
                                    ).astype(np.float32), 16000)
        (d / f"u{i}.txt").write_text(f"utterance number {i}")
    rc = main_train(["--data-root", str(tmp_path / "wavs"), "--device",
                     "cpu", "--max-steps", "2", "--output-dir",
                     str(tmp_path / "out"), "--config",
                     _cfg_file(tmp_path, gan_cfg(accum=2))])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["global_step"] == 2 and np.isfinite(res["val_l1"])
    log = [json.loads(l) for l in (tmp_path / "out" / "train_log.jsonl")
           .read_text().splitlines()]
    assert all(np.isfinite(r["vocoder/g_loss"]) for r in log[:2])


def test_fresh_init_is_flax_like_and_refiner_starts_as_identity():
    """A fresh block: biases and zero-init band outputs 0, norm scales 1,
    layer scale ``layer_scale_init``, VQ counts 1; the same seed gives the
    same model; the refiner passes its input through unchanged."""
    from ttsx_torch.train.blocks import AcousticBlock, RefinerBlock
    cfg = tiny_cfg()
    a, a2 = AcousticBlock(cfg, "cpu", 3), AcousticBlock(cfg, "cpu", 3)
    for (k, v), v2 in zip(a.model.state_dict().items(),
                          a2.model.state_dict().values()):
        assert torch.equal(v, v2), k
    sd = a.model.state_dict()
    assert torch.all(sd["film_0.gamma"] == cfg.acoustic.layer_scale_init)
    assert not sd["conformer_0.Dense_0.bias"].any()
    assert torch.all(sd["conformer_0.LayerNorm_0.weight"] == 1)
    w = sd["conformer_0.Dense_0.weight"]
    assert abs(float(w.std()) * 16 ** 0.5 - 1.0) < 0.2
    assert float(w.abs().max()) <= 2 / 0.8796 / 4 + 1e-6
    r = RefinerBlock(cfg, "cpu", 4)
    assert not r.model.band_0.band_out.weight.any()
    assert torch.all(r.model.vq.stage_0.cluster_size == 1)
    b = {k: torch.as_tensor(v) for k, v in batch_of(cfg).items()}
    with torch.no_grad():
        out = r.model(b["mel"], b["prosody"], b["style_id"].long(),
                      b["text_emb"])
    assert torch.equal(out.mel_ref, b["mel"])
