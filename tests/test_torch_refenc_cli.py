"""The speaker encoder's console scripts and the data they stand on, the
port against ``ttsx`` on the CPU: ``load_file_list``,
``SpeakerBalancedSampler``, ``load_noise_bank`` and ``WavBatchLoader``
(exactly equal batches on the same files and seed; its counts and
timeout), ``FormantCorpus`` (both ``speaker_cues``), the encoder's
``torch.export`` program, and the ``refenc-train -> eer -> fuse ->
latency`` chain in the port alone, with a port checkpoint of the
reference's weights giving the reference encoder's EER.

The chain trains the encoder at its full default width (ECAPA-TDNN 512)
for 4 steps of batch 2 on 0.8 s crops; the reference's CLI chain takes
about a minute here, so it runs in ``tests/test_torch_zoo_slow.py``, and
the reference encoder is applied once under ``jax.jit``. Tolerances: the
numpy paths exactly; ``FormantCorpus.features``' device-made entries
(mel, f0, energy, prosody) at ``ToneCorpus``' (the method is the same);
the reloaded program within 1e-6 of the port's eager encoder and 1e-5 of
the reference's ``apply`` (ECAPA 32 channels); the EER within 1e-6.
"""
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import port, randn, t, tiny_encoder
from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)

from ttsx.core import config as jc
from ttsx_torch.core import config as tc

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SR = 22050


def _write(path, wav, sr=SR):
    from ttsx_torch.data.dataset import write_wav
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(path, np.asarray(wav, np.float32), sr)
    return str(path)


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# --------------------------------------------------------------- manifests
def test_file_list_and_sampler_match_reference(tmp_path):
    from ttsx.data.dataset import SpeakerBalancedSampler as JS
    from ttsx.data.dataset import load_file_list as jload
    from ttsx_torch.data import SpeakerBalancedSampler, load_file_list
    lst = tmp_path / "list.txt"
    lst.write_text("# a comment\n\n/a/x.wav\tspk1\n  /a/y.wav spk 2  \n"
                   "/a/z.wav\n\t\n/b/with space.wav\tspk3\n# end\n")
    assert load_file_list(lst) == jload(lst)
    assert load_file_list(lst)[1] == ("/a/y.wav spk", "2")
    ids = [0, 0, 0, 1, 1, 2, 2, 2, 3, 4, 4, 4]
    for spk, utt in ((2, 2), (3, 3), (1, 1)):
        got = list(itertools.islice(SpeakerBalancedSampler(ids, spk, utt, 5),
                                    6))
        ref = list(itertools.islice(JS(ids, spk, utt, 5), 6))
        assert got == ref and len(got) == 6
    assert list(SpeakerBalancedSampler(ids, 4, 3)) == list(JS(ids, 4, 3)) == []


def test_noise_bank_matches_reference(tmp_path):
    from ttsx.data.collate import load_noise_bank as jbank
    from ttsx_torch.data import load_noise_bank
    rng = np.random.default_rng(0)
    for i, sub in enumerate(("b", "a/deep", "a", "c")):
        _write(tmp_path / sub / f"n{i}.wav", 0.3 * rng.standard_normal(
            400 * (i + 1)), 16000)
    _write(tmp_path / "a" / "empty.wav", np.zeros(0), 16000)
    (tmp_path / "a" / "notes.txt").write_text("not a wav")
    for limit in (64, 3):
        got = load_noise_bank(tmp_path, 16000, limit)
        ref = jbank(tmp_path, 16000, limit)
        assert len(got) == len(ref) == (4 if limit == 64 else 2)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


# ------------------------------------------------------------------ loader
def _loader_tree(root):
    """Three wavs longer than the crop, one shorter, one undecodable."""
    rng = np.random.default_rng(1)
    items = [(_write(root / f"long{i}.wav", 0.2 * rng.standard_normal(
        3000 + 700 * i), 16000), i) for i in range(3)]
    items.append((_write(root / "short.wav", 0.2 * rng.standard_normal(300),
                         16000), 3))
    bad = root / "broken.wav"
    bad.write_bytes(b"RIFF\x00\x00garbage, not a wav file")
    return items + [(str(bad), 4)]


def _batches(loader, n):
    return [loader.next(timeout_ms=10000) for _ in range(n)]


def test_wav_batch_loader_matches_reference(tmp_path):
    """The Python-thread executors (``native=False``), one worker, same
    files and seed: the same three batches (crops, zero padding, labels);
    on a list of broken files only, every row -1 and zero, as in the
    reference. The port counts what it did (the reference's Python
    executor reports zeros). The native executors are held to each other
    in tests/test_torch_native.py."""
    from ttsx.data.prefetch import WavBatchLoader as J
    from ttsx_torch.data import WavBatchLoader
    from ttsx_torch.data.prefetch import RETRIES
    items = _loader_tree(tmp_path)
    kw = dict(crop=1000, batch=6, sample_rate=16000, workers=1, seed=3)
    with WavBatchLoader(items, native=False, **kw) as got, J(
            items, native=False, **kw) as ref:
        gb, rb = _batches(got, 3), _batches(ref, 3)
        assert not got.is_native and not ref.is_native
        assert ref.stats() == (0, 0, 0)
        produced, consumed, errors = got.stats()
    for (gw, gl), (rw, rl) in zip(gb, rb):
        assert gw.dtype == rw.dtype == np.float32 and gl.dtype == rl.dtype
        np.testing.assert_array_equal(gw, rw)
        np.testing.assert_array_equal(gl, rl)
    labels = np.concatenate([l for _, l in gb])
    assert {3} <= set(labels) and 4 not in labels   # padded rows, no broken
    short = np.concatenate([w for w, _ in gb])[labels == 3]
    assert np.all(short[:, 300:] == 0) and np.any(short[:, :300] != 0)
    assert consumed == 3 and produced >= 3 and errors > 0
    assert not any(t.is_alive() for t in got._threads)

    broken = [items[-1]]
    with WavBatchLoader(broken, native=False, **kw) as got, J(
            broken, native=False, **kw) as ref:
        (gw, gl), (rw, rl) = got.next(10000), ref.next(10000)
        produced, consumed, errors = got.stats()
    np.testing.assert_array_equal(gl, rl)
    np.testing.assert_array_equal(gw, rw)
    assert (gl == -1).all() and not gw.any()
    assert consumed == 1 and errors >= RETRIES * 6 * produced
    assert errors % (RETRIES * 6) == 0


def test_wav_batch_loader_timeout_and_native(tmp_path):
    from ttsx.data.prefetch import WavBatchLoader as J
    from ttsx_torch.data import WavBatchLoader
    items = _loader_tree(tmp_path)[:1]
    for cls in (WavBatchLoader, J):
        with cls(items, crop=100, batch=2, workers=0, native=False) as idle:
            with pytest.raises(TimeoutError, match="50 ms"):
                idle.next(timeout_ms=50)
    # native=True takes the pthreads executor, which builds here (its
    # failed build raises: tests/test_torch_native.py)
    with WavBatchLoader(items, crop=100, batch=2, native=True) as native:
        assert native.is_native
        assert native.next(timeout_ms=10000)[0].shape == (2, 100)


# ------------------------------------------------------------------ corpus
@pytest.mark.parametrize("cues", ["vtl", "rich"])
def test_formant_corpus_matches_reference(cues):
    from ttsx.data.formantcorpus import FormantCorpus as J
    from ttsx_torch.data.formantcorpus import FormantCorpus
    kw = dict(n_speakers=3, n_phonemes=6, text_dim=8, seed=2,
              n_f0_groups=2, noise_db=25.0, intonation=0.1,
              speaker_cues=cues)
    pc = FormantCorpus(audio=tc.AudioConfig(), **kw)
    jcorp = J(audio=jc.AudioConfig(), **kw)
    for k in ("spk_f0", "spk_vtl", "spk_bw", "spk_breath_mul", "spk_tilt",
              "spk_vib_rate", "spk_vib_depth", "pho_formants", "pho_gain",
              "pho_breath", "pho_emb"):
        np.testing.assert_array_equal(getattr(pc, k), getattr(jcorp, k))
    pu, ju = pc.utterances(2, 30, seed=1), jcorp.utterances(2, 30, seed=1)
    for a, b in zip(pu, ju):
        np.testing.assert_array_equal(a.wav, b.wav)
        np.testing.assert_array_equal(a.phoneme_ids, b.phoneme_ids)
        assert (a.speaker, a.f0_hz) == (b.speaker, b.f0_hz)
    got, ref = pc.features(pu[:3], device="cpu"), jcorp.features(ju[:3])
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    for k in ("wav", "text_emb", "speaker_id", "style_id", "emotion_probs",
              "frame_mask"):
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_allclose(got["mel"], ref["mel"], atol=1e-4)
    np.testing.assert_allclose(got["f0"], ref["f0"], rtol=1e-5)
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)
    np.testing.assert_allclose(got["prosody"], ref["prosody"], atol=1e-4)
    with pytest.raises(ValueError, match="speaker_cues"):
        FormantCorpus(speaker_cues="pitch")


# ------------------------------------------------------------------ export
def test_export_program_reloads_and_matches(tmp_path):
    from ttsx.models.reference_encoder import ReferenceEncoder as J
    from ttsx_torch.eval import (aot_compile, export_reference_encoder,
                                 load_pt2)
    from ttsx_torch.models.reference_encoder import ReferenceEncoder
    kw, tree = tiny_encoder()
    model = port(ReferenceEncoder(tc.RefEncConfig(**kw)), tree)
    path = tmp_path / "enc.pt2"
    blob = export_reference_encoder(model, path)
    assert blob == path.read_bytes() and len(blob) > 0
    program = load_pt2(path)
    mel = randn(3, 1, 172, 80)
    with torch.no_grad():
        got, eager = program(t(mel)), model(t(mel))
        again = aot_compile(model, (t(mel),))(t(mel))
    np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(again.numpy(), eager.numpy(), rtol=0,
                               atol=1e-6)
    ref = jax.jit(J(jc.RefEncConfig(**kw)).apply)(tree, mel)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


# -------------------------------------------------------------------- CLIs
def formant_list(root, n_speakers, per_speaker, frames, seed=0, name="list"):
    """A FormantCorpus wav tree at 22.05 kHz and its path<TAB>speaker
    list."""
    from ttsx_torch.data.formantcorpus import FormantCorpus
    corpus = FormantCorpus(n_speakers=n_speakers, audio=tc.AudioConfig())
    lines = []
    for i, u in enumerate(corpus.utterances(per_speaker, frames, seed=seed)):
        path = _write(root / f"spk{u.speaker}" / f"{name}{i}.wav", u.wav)
        lines.append(f"{path}\tspk{u.speaker}")
    lst = root / f"{name}.tsv"
    lst.write_text("\n".join(lines) + "\n")
    return lst


def test_refenc_cli_chain(tmp_path, capsys):
    """refenc-train (4 steps, batch 2, 0.8 s crops, EER every 2 steps on a
    held-out list) -> eer --checkpoint -> fuse -> latency, all at the
    encoder's full width on the CPU; eer without a checkpoint exits."""
    from ttsx_torch.cli.main import (main_refenc_eer, main_refenc_fuse,
                                     main_refenc_latency, main_refenc_train)
    train = formant_list(tmp_path, 3, 2, 100)
    held = formant_list(tmp_path, 3, 2, 90, seed=1, name="held")
    out = tmp_path / "run"
    assert main_refenc_train([str(train), "--device", "cpu", "--eval-list",
                              str(held), "--max-steps", "4", "--batch", "2",
                              "--crop-seconds", "0.8", "--eval-every", "2",
                              "--workers", "1", "--output-dir",
                              str(out)]) == 0
    res = _json(capsys)
    ckpt = out / "checkpoints"
    assert res == {"steps": 4, "best_eer": res["best_eer"], "n_speakers": 3,
                   "native_loader": True, "checkpoints": str(ckpt)}
    assert 0.0 <= res["best_eer"] <= 1.0
    assert (ckpt / "best" / "meta.json").exists()
    assert json.loads((ckpt / "final" / "meta.json").read_text())["step"] == 4

    assert main_refenc_eer([str(held), "--device", "cpu", "--checkpoint",
                            str(ckpt)]) == 0
    eer = _json(capsys)
    assert set(eer) == {"eer", "n"} and eer["n"] == 6
    with pytest.raises(SystemExit) as e:
        main_refenc_eer([str(held), "--device", "cpu"])
    assert e.value.code == 2
    capsys.readouterr()

    pt2 = tmp_path / "enc.pt2"
    assert main_refenc_fuse(["--device", "cpu", "--checkpoint", str(ckpt),
                             "--out", str(pt2)]) == 0
    fuse = _json(capsys)
    assert fuse == {"path": str(pt2), "bytes": pt2.stat().st_size,
                    "aot_compiled": True} and fuse["bytes"] > 0

    assert main_refenc_latency(["--device", "cpu", "--runs", "2"]) == 0
    lat = _json(capsys)
    assert lat["runs"] == 2 and lat["avg_ms"] > 0


def test_checkpoint_eer_equals_reference_encoder(tmp_path, capsys):
    """The reference encoder's weights (its full-width init), carried by
    ``weights.py`` into a port checkpoint: ``refenc-eer --checkpoint``
    gives the EER of the reference's encoder (under ``jax.jit``) on the
    same equal-length files."""
    from ttsx.dsp import mel_spectrogram as jmel
    from ttsx.eval.metrics import all_pairs_eer as jeer
    from ttsx.models.reference_encoder import ReferenceEncoder as J
    from ttsx_torch.cli.main import main_refenc_eer
    from ttsx_torch.data import load_file_list, read_wav
    from ttsx_torch.train.checkpoint import save_checkpoint
    from ttsx_torch.train.refenc_trainer import RefEncTrainer
    from ttsx_torch.weights import load_flax
    lst = formant_list(tmp_path, 4, 3, 80, seed=2)
    items = load_file_list(lst)
    jcfg = jc.RefEncConfig(num_speakers=4)
    jmodel = J(jcfg)
    audio = jc.AudioConfig()
    mel = jmel(jnp.asarray(np.stack([read_wav(p, SR)[0] for p, _ in items])),
               audio)
    tree = jax.jit(jmodel.init)(jax.random.PRNGKey(7), mel[:1])
    emb = np.asarray(jax.jit(jmodel.apply)(tree, mel))
    spk = np.asarray([int(s[3:]) for _, s in items])
    ref = jeer(emb, spk)

    trainer = RefEncTrainer(tc.RefEncConfig(num_speakers=4), "cpu")
    load_flax(trainer.params.model, jax.tree_util.tree_map(np.asarray, tree))
    save_checkpoint(str(tmp_path / "ckpt"), "final",
                    {"refenc": trainer.state.state_dict()}, 1)
    assert main_refenc_eer([str(lst), "--device", "cpu", "--checkpoint",
                            str(tmp_path / "ckpt")]) == 0
    got = _json(capsys)
    assert got["n"] == 12 and 0.0 < ref < 0.5
    assert abs(got["eer"] - ref) <= 1e-6
