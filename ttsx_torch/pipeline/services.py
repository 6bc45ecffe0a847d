"""Host-side external-model service registry.

The reference leans on eight external pretrained systems (SURVEY §2.9):
wav2vec2 SSL features, Whisper/WhisperX ASR, ECAPA + Resemblyzer speaker
embeddings, Silero VAD, Demucs separation, BART summarization, and
spaCy/Stanza NLP. None are portable to this image and all are out-of-scope
to retrain; each sits behind a narrow interface here with a batch
contract and a deterministic fallback, so plugging a real model in is
one `register()` call — no pipeline code changes.

Every interface accepts/returns plain numpy so services can live in other
processes (HTTP/subprocess) without touching the device's state.

A copy of ``ttsx/pipeline/services.py``; the fallbacks that run on a
device (the ASR's energy VAD, the SSL features' log-mel, the VAD's
STFT) take ``device`` (default ``"cuda"``) and run there.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

_REGISTRY: Dict[str, Callable] = {}


def register(name: str, fn: Callable) -> None:
    """Register a service implementation: 'asr', 'ssl_features',
    'separation', 'summarizer', 'nlp', 'vad'."""
    _REGISTRY[name] = fn


def get(name: str) -> Optional[Callable]:
    return _REGISTRY.get(name)


def clear(name: Optional[str] = None) -> None:
    if name is None:
        _REGISTRY.clear()
    else:
        _REGISTRY.pop(name, None)


# ---------------------------------------------------------------------------
# contracts + fallbacks
# ---------------------------------------------------------------------------
def asr_transcribe(wav: np.ndarray, sr: int, device="cuda") -> Dict:
    """{"segments": [{start, end, text, avg_logprob}], "language": str?}.
    Fallback: energy-VAD segmentation with empty text
    (ttsx_torch.pipeline.asr)."""
    fn = get("asr")
    if fn is not None:
        return fn(wav, sr)
    from ttsx_torch.pipeline.asr import ASRService
    return ASRService(device=device).transcribe(wav, sr)


def ssl_features(wav_batch: np.ndarray, sr: int, device="cuda") -> np.ndarray:
    """[B, N] wavs -> [B, L, H] SSL feature sequences (wav2vec2-class,
    encoder.py:64-75). Fallback: framed log-mel as the feature sequence —
    shape-compatible with the ReferenceEncoder 'ssl_host' backbone."""
    fn = get("ssl_features")
    if fn is not None:
        return fn(wav_batch, sr)
    import torch
    from ttsx_torch.core.config import AudioConfig
    from ttsx_torch.core.device import resolve_device
    from ttsx_torch.dsp.stft import mel_spectrogram
    cfg = AudioConfig(sample_rate=sr)
    x = torch.as_tensor(np.asarray(wav_batch, np.float32),
                        device=resolve_device(device))
    return mel_spectrogram(x, cfg).cpu().numpy()


def separate_vocals(wav: np.ndarray, sr: int) -> np.ndarray:
    """Demucs-class vocal separation for overlap regions
    (audio_rebuilder.py:29-32). Fallback: identity."""
    fn = get("separation")
    return fn(wav, sr) if fn is not None else wav


def summarize(texts: List[str], max_words: int = 12) -> str:
    """BART-class summarization (plot_map.py:56-69). Fallback: extractive
    most-polarized sentence (ttsx_torch.pipeline.plot_map.default_summarize)."""
    fn = get("summarizer")
    if fn is not None:
        return fn(texts, max_words)
    from ttsx_torch.pipeline.plot_map import default_summarize
    return default_summarize(texts, max_words)


def nlp_negation(text: str) -> bool:
    """spaCy/negspacy-class negation detection (tier2.py). Fallback:
    token heuristic."""
    fn = get("nlp")
    if fn is not None:
        return bool(fn(text))
    words = text.lower().split()
    return any(w in ("not", "no", "never", "without", "hardly")
               or w.endswith("n't") for w in words)


def vad_probs(wav: np.ndarray, sr: int, device="cuda") -> np.ndarray:
    """Silero-class frame speech probabilities (slicer.py:19). Fallback:
    fused energy+flatness VAD (ttsx_torch.pipeline.diarizer.slicer)."""
    fn = get("vad")
    if fn is not None:
        return fn(wav, sr)
    from ttsx_torch.core.config import AudioConfig
    from ttsx_torch.pipeline.diarizer.slicer import vad_probabilities
    return vad_probabilities(wav, AudioConfig(sample_rate=sr),
                             device=device)
