"""The port's data path against ``ttsx`` on the CPU: wav reading, the
dataset's items, the collator (augment on, same seed) with the
reference's mel route on its accelerator (the Pallas K3 in interpret
mode, not its CPU default ``mel_spectrogram``, which differs on the
zero padding), the trainer-batch adapter and synthetic batches."""
import jax.numpy as jnp
import numpy as np
import pytest

from ttsx.core.config import AudioConfig as JAudio
from ttsx_torch.core.config import AudioConfig

SMALL = dict(sample_rate=16000, n_fft=256, win_length=256, hop_length=64,
             n_mels=32)
WORDS = ["hello world", "the quick brown fox", "a b c", "speech data",
         "one more line here"]


def _wav_tree(root, sr=16000, n_spk=2, seed=0):
    """<spk>/<dom>/<style>/*.wav of 0.3-0.9 s tones in noise, with
    transcripts beside them."""
    from ttsx.data.dataset import write_wav
    rng = np.random.default_rng(seed)
    k = 0
    for s in range(n_spk):
        for style in ("calm", "loud"):
            d = root / f"spk{s}" / "read" / style
            d.mkdir(parents=True)
            for u in range(2):
                n = int(rng.integers(int(0.3 * sr), int(0.9 * sr)))
                tt = np.arange(n) / sr
                wav = (0.4 * np.sin(2 * np.pi * rng.uniform(100, 300) * tt)
                       + 0.05 * rng.normal(size=n))
                write_wav(d / f"u{u}.wav", wav.astype(np.float32), sr)
                (d / f"u{u}.txt").write_text(WORDS[k % len(WORDS)])
                k += 1
    return root


def test_read_wav_matches_reference(tmp_path):
    """int16 stereo at 16 kHz: the same samples at the native rate and
    linearly resampled to 22.05 kHz (1e-6: the reference's native
    decoder mixes and scales in one C loop)."""
    from scipy.io import wavfile
    from ttsx.data.dataset import read_wav as jread
    from ttsx_torch.data.dataset import read_wav
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(3000, 2)) * 8000).astype(np.int16)
    path = tmp_path / "x.wav"
    wavfile.write(path, 16000, data)
    for sr in (None, 22050):
        got, got_sr = read_wav(path, sr)
        ref, ref_sr = jread(path, sr)
        assert got_sr == ref_sr and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _datasets(root, audio, jaudio, **kw):
    from ttsx.data.dataset import TTSDataset as JDS, TTSDatasetConfig as JDC
    from ttsx_torch.data.dataset import TTSDataset, TTSDatasetConfig
    return (TTSDataset(TTSDatasetConfig(str(root), audio=audio, **kw)),
            JDS(JDC(str(root), audio=jaudio, **kw)))


def test_dataset_items_match_reference(tmp_path):
    ds, jds = _datasets(_wav_tree(tmp_path), AudioConfig(**SMALL),
                        JAudio(**SMALL), text_emb_dim=24)
    assert len(ds) == len(jds) == 8
    assert (ds.spk2id, ds.dom2id, ds.sty2id) == (jds.spk2id, jds.dom2id,
                                                  jds.sty2id)
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
            else:
                assert a[k] == b[k], k


@pytest.fixture(scope="module")
def collated(tmp_path_factory):
    """One batch of 5 items (mixed lengths, one bucket) through both
    collators with augmentation and SpecAugment on, the same seed."""
    from ttsx.data.collate import CollatorConfig as JCC, TTSCollator as JColl
    from ttsx.dsp.features import extract_f0_energy as jf0
    from ttsx.ops.mel_kernel import mel_frontend_pallas
    from ttsx_torch.data.collate import CollatorConfig, TTSCollator
    audio, jaudio = AudioConfig(**SMALL), JAudio(**SMALL)
    ds, jds = _datasets(_wav_tree(tmp_path_factory.mktemp("wavs")), audio,
                        jaudio, text_emb_dim=24)
    idx = [0, 3, 5, 6, 7]
    port = TTSCollator(CollatorConfig(audio=audio, seed=3), device="cpu")
    ref = JColl(JCC(audio=jaudio, seed=3),
                mel_fn=lambda w: np.asarray(mel_frontend_pallas(
                    jnp.asarray(w), jaudio, interpret=True)),
                f0_fn=lambda w: tuple(np.asarray(x) for x in jf0(
                    jnp.asarray(w), jaudio)))
    return (port([ds[i] for i in idx], batch_idx=2),
            ref([jds[i] for i in idx], batch_idx=2))


def test_collator_matches_reference(collated):
    """Augmented wavs, ids, masks and lengths equal; the normalised
    log-mel within tests/test_ops.py's normalised tolerance (5e-3 abs,
    1e-2 rel); f0 and energy within 1e-4 (f0 equal where both voiced)."""
    got, ref = collated
    assert set(got) == set(ref)
    for k in ("wav", "wav_length", "frame_length", "frame_mask", "text_ids",
              "text_mask", "text_length", "text_emb", "speaker_id",
              "domain_id", "style_id"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["transcripts"] == ref["transcripts"]
    assert got["wav"].shape[1] % 8192 == 0
    np.testing.assert_allclose(got["mel"], ref["mel"], rtol=1e-2, atol=5e-3)
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["f0"], ref["f0"], rtol=1e-4, atol=1e-4)
    assert (got["mel"] == 0).any()          # SpecAugment masks applied


def test_adapter_and_synthetic_batches_match_reference(collated):
    """Trainer batches from the collated batch (the [B, D] sentence
    embedding broadcast over T, f0 z-scores, energy) and synthetic
    batches: equal arrays."""
    from ttsx.core import config as jc
    from ttsx.data.adapters import collator_to_trainer_batch as jadapt
    from ttsx.data.synthetic import synthetic_batch as jsynth
    from ttsx_torch.core import config as tc
    from ttsx_torch.data.adapters import collator_to_trainer_batch
    from ttsx_torch.data.synthetic import synthetic_batch
    cfg = tc.TTSXConfig(acoustic=tc.AcousticConfig(text_emb_dim=24))
    jcfg = jc.from_dict(jc.TTSXConfig, tc.to_dict(cfg))
    got = collator_to_trainer_batch(collated[0], cfg)
    ref = jadapt(collated[0], jcfg)
    assert set(got) == set(ref)
    assert got["text_emb"].shape == got["mel"].shape[:2] + (24,)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    got, ref = synthetic_batch(cfg, 2, 8, seed=5), jsynth(jcfg, 2, 8, seed=5)
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_collated_mel_overruns_the_wav_by_one_hop(collated):
    """Reference fact the vocoder block must settle when it is ported: the
    centred STFT gives N // hop + 1 frames for a bucket of N samples, so a
    generator that emits hop samples per frame overruns the collated wav
    by one hop (the reference's ``VocoderBlock.gen_step`` then fails its
    feature matching on collated batches)."""
    got, ref = collated
    hop = SMALL["hop_length"]
    for batch in (got, ref):
        n_wav, n_frames = batch["wav"].shape[1], batch["mel"].shape[1]
        assert n_frames == n_wav // hop + 1
        assert n_frames * hop == n_wav + hop
