"""Shared helpers of the parity harnesses (``ttsx/eval/parity_common.py``):
the corpus factory, the mel-space normalisation bookkeeping, batch
sampling, the de-normalised MCD and the waveform-quality readout.

The numpy parts are the reference's, line for line. The mels go through
``dsp.stft.mel_spectrogram`` and ``stft_magnitude`` (the plain ``|rfft|``
route, as the reference's; K3 is the collator's kernel, not this one's)
on the experiment's device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ttsx_torch.core.config import AudioConfig
from ttsx_torch.core.device import resolve_device, set_f32_numerics
# the unnormalized natural-log mel, so that MCD's 10 / ln 10 gives dB
from ttsx_torch.zoo import AUDIO

_STATS_KEYS = ("mel_raw", "mel_mean", "mel_std")


def experiment_device(device="cuda") -> torch.device:
    """``resolve_device(device)``, with full-f32 numerics on the card: the
    reference synthesizes and trains at matmul precision "highest" (its
    ``_synth_wav``), which is the port's with TF32 off."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_f32_numerics()
    return dev


def make_corpus(kind: str = "tone", **kw):
    """"tone" = ``ToneCorpus`` (narrowband additive harmonics); "formant"
    = ``FormantCorpus`` (wideband source-filter audio); "formant_rich" =
    the same with per-speaker voice-quality cues."""
    from ttsx_torch.data.tonecorpus import ToneCorpus
    if kind == "tone":
        return ToneCorpus(**kw)
    if kind in ("formant", "formant_rich"):
        from ttsx_torch.data.formantcorpus import FormantCorpus
        if kind == "formant_rich":
            kw["speaker_cues"] = "rich"
        return FormantCorpus(**kw)
    raise ValueError(f"unknown corpus kind {kind!r} (expected 'tone', "
                     "'formant' or 'formant_rich')")


def _mel(wav: np.ndarray, audio: AudioConfig, device) -> np.ndarray:
    from ttsx_torch.dsp.stft import mel_spectrogram
    w = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    return mel_spectrogram(w, audio).cpu().numpy()


def mel_energy_gain(wav: np.ndarray, mel_req: np.ndarray,
                    audio: AudioConfig, device="cuda") -> np.ndarray:
    """Per-utterance gain matching the re-analysed mel energy of ``wav``
    [B, N] to a requested raw log-mel [B, T, M], in the linear energy
    domain (sqrt of the ratio of mean exp(2 mel)): input-only loudness
    normalisation for the vocoder."""
    mel_gen = _mel(wav, audio, resolve_device(device))
    t = min(mel_gen.shape[1], mel_req.shape[1])
    e_req = np.exp(2.0 * mel_req[:, :t]).mean(axis=(1, 2))
    e_gen = np.exp(2.0 * mel_gen[:, :t]).mean(axis=(1, 2))
    return np.sqrt(e_req / np.maximum(e_gen, 1e-20))


def _speaker_vec(ids: np.ndarray, dim: int, n_speakers: int) -> np.ndarray:
    """One-hot speaker conditioning padded/cropped to `dim`."""
    eye = np.eye(max(n_speakers, dim), dtype=np.float32)[:, :dim]
    return eye[ids]


def _normalize_mels(d: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The raw log-mel swapped for its per-utterance per-bin normalisation,
    the stats kept (``mel_raw``, ``mel_mean``, ``mel_std``) to measure MCD
    on de-normalised predictions, and ``mel_scale`` = [mean || std] per
    utterance [B, 2M], the scale_cond channel's input."""
    raw = d["mel"]
    mean = raw.mean(axis=1, keepdims=True)
    std = raw.std(axis=1, keepdims=True) + 1e-5
    out = dict(d)
    out["mel"] = ((raw - mean) / std).astype(np.float32)
    out["mel_raw"], out["mel_mean"], out["mel_std"] = raw, mean, std
    out["mel_scale"] = np.concatenate(
        [mean[:, 0, :], std[:, 0, :]], axis=-1).astype(np.float32)
    return out


def _model_batch(d: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip eval-only stats keys from a features dict."""
    return {k: v for k, v in d.items() if k not in _STATS_KEYS}


def _denorm_mcd(pred_norm: np.ndarray, data: Dict[str, np.ndarray],
                j: int, mcd_fn) -> float:
    """MCD dB between a normalized prediction and the raw target mel."""
    raw = pred_norm * data["mel_std"][j] + data["mel_mean"][j]
    return mcd_fn(raw, data["mel_raw"][j])


def _acoustic_preds(a_block, data: Dict[str, np.ndarray], batch: int):
    """Batched acoustic ``val_step`` over a features dict; returns
    (mel_pred [N, T, C], data truncated to the N full batches)."""
    preds = []
    mb_all = _model_batch(data)
    for i in range(0, len(data["mel"]), batch):
        mb = {k: v[i:i + batch] for k, v in mb_all.items()}
        if mb["mel"].shape[0] < batch:
            break
        preds.append(a_block.val_step(mb)["mel_pred"].cpu().numpy())
    n = len(preds) * batch
    return np.concatenate(preds), {k: v[:n] for k, v in data.items()}


def _batch_sampler(feats: Dict[str, np.ndarray], batch: int, seed: int):
    rng = np.random.default_rng(seed)
    n = len(feats["mel"])
    while True:
        idx = rng.integers(0, n, batch)
        yield {k: v[idx] for k, v in feats.items()}


_STFT_RES = ((512, 128), (1024, 256), (2048, 512))

# natural-log-mel drop of 40 dB below the utterance peak: both spectra
# are clamped there before the cepstral transform, which bounds the
# noise-floor term of the raw MCD (unbounded quiet-bin log ratios)
_MCD_DR40 = 40.0 * np.log(10.0) / 10.0


def _wav_quality(wav_fake: np.ndarray, wav_real: np.ndarray,
                 device="cuda") -> Dict:
    """Waveform quality of ``wav_fake`` against ``wav_real`` (both [B, N]
    in [-1, 1]): the re-analysis mel MCD, its 40 dB-range and voiced-only
    forms, the multi-resolution STFT log-L1, the rms ratio, and the
    per-utterance std of each."""
    from ttsx_torch.dsp.stft import stft_magnitude
    from ttsx_torch.eval.metrics import mel_cepstral_distortion

    dev = resolve_device(device)
    mel_f = _mel(wav_fake, AUDIO, dev)
    mel_r = _mel(wav_real, AUDIO, dev)
    mcds = [mel_cepstral_distortion(mel_f[i], mel_r[i])
            for i in range(mel_f.shape[0])]
    mcds_dr = []
    for i in range(mel_f.shape[0]):
        t = min(len(mel_f[i]), len(mel_r[i]))
        floor = mel_r[i][:t].max() - _MCD_DR40  # reference-anchored
        mcds_dr.append(mel_cepstral_distortion(
            np.maximum(mel_f[i][:t], floor), np.maximum(mel_r[i][:t], floor)))
    # voiced-only MCD: frames in the lower 35 % of the utterance's
    # loudness range (log of the mean linear energy) are masked when that
    # range is bimodal (wider than 3 log-mel units), else every frame
    mcds_v, voiced = [], []
    for i in range(mel_f.shape[0]):
        t = min(len(mel_f[i]), len(mel_r[i]))
        loud = np.log(np.mean(np.exp(mel_r[i][:t]), axis=-1) + 1e-12)
        rng_ = loud.max() - loud.min()
        if rng_ < 3.0:
            mask = np.ones(t, dtype=bool)
        else:
            mask = loud > loud.min() + 0.35 * rng_
        if mask.sum() >= 2:
            mcds_v.append(mel_cepstral_distortion(
                mel_f[i][:t][mask], mel_r[i][:t][mask]))
            voiced.append(float(mask.mean()))
    stft_l1_utt = 0.0  # [B] per-utterance accumulator across resolutions
    for n_fft, hop in _STFT_RES:
        mf, mr = (stft_magnitude(torch.as_tensor(
            np.asarray(w, np.float32), device=dev), n_fft, hop).cpu().numpy()
            for w in (wav_fake, wav_real))
        stft_l1_utt = stft_l1_utt + np.mean(
            np.abs(np.log(mf + 1e-5) - np.log(mr + 1e-5)), axis=(1, 2))
    stft_l1_utt = stft_l1_utt / len(_STFT_RES)
    rms = lambda w, ax=None: np.sqrt(np.mean(np.square(w), axis=ax) + 1e-12)
    rms_utt = rms(wav_fake, ax=1) / rms(wav_real, ax=1)  # per-utterance
    out = {"wav_mcd_db": float(np.mean(mcds)),
           "wav_mcd_db_std": float(np.std(mcds)),
           "wav_mcd_dr40_db": float(np.mean(mcds_dr)),
           "wav_mcd_dr40_db_std": float(np.std(mcds_dr)),
           "stft_log_l1": float(np.mean(stft_l1_utt)),
           "stft_log_l1_std": float(np.std(stft_l1_utt)),
           # amplitude sanity: ~1.0 when the generator reproduces energy
           "rms_ratio": float(rms(wav_fake) / rms(wav_real)),
           "rms_ratio_utt_std": float(np.std(rms_utt))}
    if mcds_v:
        out["wav_mcd_voiced_db"] = float(np.mean(mcds_v))
        out["voiced_frac"] = float(np.mean(voiced))
    return out
