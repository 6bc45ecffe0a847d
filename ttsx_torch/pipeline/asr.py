"""Host-side ASR / prosody-extract stages with pluggable service backends
(``ttsx/pipeline/asr.py``).

The reference runs WhisperX + ProsodyPredictorV15 per speaker
(reference_encoder/main.py:96-107, 322-383; modules/transcription/*).
External pretrained ASR nets are out-of-scope to retrain (SURVEY §2.9);
they sit behind the `ASRService` interface. The default backend is an
energy-VAD segmenter that emits timing-accurate segments with empty text —
every downstream JSON contract holds; a Whisper-class service can be
plugged in via `transcribe_fn` when available.

Prosody extraction runs f0 / energy and, given weights, the
``ProsodyPredictor`` over the mel frontend on ``device``; the segmenting,
rounding and JSON writes are the reference's, line for line. The energy
VAD runs on the ASR service's ``device``. Both default to ``"cuda"``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ttsx_torch.core.config import AudioConfig, ProsodyConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.pipeline.contracts import Stage, speaker_dir, write_json_atomic


class ASRService:
    """transcribe(wav, sr) -> {"segments": [{start, end, text, avg_logprob}]}"""

    def __init__(self, transcribe_fn: Optional[Callable] = None,
                 audio: AudioConfig | None = None,
                 vad_threshold: float = 0.05, min_gap_s: float = 0.3,
                 device="cuda"):
        self.transcribe_fn = transcribe_fn
        self.audio = audio or AudioConfig()
        self.vad_threshold = vad_threshold
        self.min_gap_s = min_gap_s
        self.device = resolve_device(device)

    def transcribe(self, wav: np.ndarray, sr: int) -> Dict:
        if self.transcribe_fn is not None:
            return self.transcribe_fn(wav, sr)
        # VAD segmentation fallback: correct timings, empty text
        from ttsx_torch.dsp.features import energy_vad
        x = torch.as_tensor(np.asarray(wav[None], np.float32),
                            device=self.device)
        v = energy_vad(x, self.audio).cpu().numpy()[0]
        hop_s = self.audio.hop_length / self.audio.sample_rate
        segments: List[Dict] = []
        start = None
        gap = 0
        max_gap = int(self.min_gap_s / hop_s)
        for i, on in enumerate(v):
            if on:
                if start is None:
                    start = i
                gap = 0
            elif start is not None:
                gap += 1
                if gap > max_gap:
                    segments.append(self._seg(start, i - gap, hop_s))
                    start, gap = None, 0
        if start is not None:
            segments.append(self._seg(start, len(v) - 1, hop_s))
        return {"segments": segments, "language": None}

    @staticmethod
    def _seg(a: int, b: int, hop_s: float) -> Dict:
        return {"start": round(a * hop_s, 3), "end": round((b + 1) * hop_s, 3),
                "text": "", "avg_logprob": 0.0, "vad_score": 1.0}


# sentences for ``ScriptedText``: lexicon words, negations, intensifiers
# and the rule table's keywords, so that the tier, anomaly and plot-map
# stages meet every kind of input
SCRIPT = (
    "I love this wonderful day and I am so happy!",
    "this is terrible, I hate it and I am furious",
    "the meeting is at noon in the main room",
    "I am not happy about this at all",
    "thank you, I am really grateful for your help",
    "I am scared and terrified of what comes next",
    "we are not safe. we never were",
    "um I am unsure, maybe we should wait",
    "that was funny haha, I laugh every time",
    "I feel so alone and lonely tonight",
    "the report is factual and informative",
    "but however it went, I hope we win",
)


class ScriptedText:
    """A ``transcribe_fn`` for runs without a speech recognizer (smoke
    and parity runs): the segments of ``segmenter`` (an ``ASRService``
    without a ``transcribe_fn``, of either package), the k-th given
    ``sentences[(k + len(wav)) % len(sentences)]`` as its text. The text
    is a function of the segmentation and the wav's length alone."""

    def __init__(self, segmenter, sentences=SCRIPT):
        self.segmenter = segmenter
        self.sentences = sentences

    def __call__(self, wav: np.ndarray, sr: int) -> Dict:
        out = self.segmenter.transcribe(wav, sr)
        n = len(self.sentences)
        for k, seg in enumerate(out["segments"]):
            seg["text"] = self.sentences[(k + len(wav)) % n]
        return out


class TranscriptionStage(Stage):
    """Per-speaker transcription with VAD cleanup and >N-sample chunking
    (modules/transcription/transcription.py:15-136)."""
    name = "transcription"

    def __init__(self, asr: Optional[ASRService] = None,
                 chunk_s: float = 600.0, overlap_s: float = 0.5):
        self.asr = asr or ASRService()
        self.chunk_s = chunk_s
        self.overlap_s = overlap_s

    def run(self, context: Dict) -> Dict:
        from ttsx_torch.data.dataset import read_wav
        results = {}
        sr = self.asr.audio.sample_rate
        for spk in context.get("speaker_ids", []):
            wav_path = Path(context["output_dir"]) / "speakers" / f"{spk}.wav"
            if not wav_path.exists():
                continue
            wav, _ = read_wav(wav_path, sr)
            chunk = int(self.chunk_s * sr)
            segments: List[Dict] = []
            if len(wav) <= chunk:
                segments = self.asr.transcribe(wav, sr)["segments"]
            else:
                # 10-min chunking with offset merge (transcription.py:37-52)
                step = chunk - int(self.overlap_s * sr)
                for off in range(0, len(wav), step):
                    part = wav[off:off + chunk]
                    if len(part) < sr // 2:
                        break
                    segs = self.asr.transcribe(part, sr)["segments"]
                    t0 = off / sr
                    for s in segs:
                        segments.append({**s, "start": s["start"] + t0,
                                         "end": s["end"] + t0})
                segments.sort(key=lambda s: s["start"])
            d = speaker_dir(context, spk)
            write_json_atomic(d / "transcript.json", {"segments": segments})
            results[spk] = {"n_segments": len(segments)}
        return {"speakers": results}


class ProsodyExtractStage(Stage):
    """Per-speaker prosody trend via the ProsodyPredictor + DSP f0 on
    ``device`` (main.py:322-352 prosody_extract). ``params`` is the
    predictor's weights as a flax-layout variables tree (the reference's
    form, loaded into ``ProsodyPredictor(cfg)`` through
    ``weights.load_flax``) or a ``ProsodyPredictor`` on ``device``
    (``zoo.load_prosody``), whose own config then replaces ``cfg``; None:
    the DSP trend only."""
    name = "prosody"

    def __init__(self, cfg: Optional[ProsodyConfig] = None, params=None,
                 max_frames: int = 4096, device="cuda"):
        self.device = resolve_device(device)
        self._predictor = None
        if isinstance(params, torch.nn.Module):
            on = next(params.parameters()).device
            if on != torch.empty(0, device=self.device).device:  # cuda:0
                raise ValueError(f"the predictor is on {on}, the stage on "
                                 f"{self.device}")
            self._predictor = params.eval()
            cfg = params.cfg
        self.cfg = cfg or ProsodyConfig()
        self.params = params  # None -> DSP-only trend (no model)
        self.max_frames = max_frames

    def run(self, context: Dict) -> Dict:
        from ttsx_torch.data.dataset import read_wav
        from ttsx_torch.dsp.features import extract_f0_energy
        from ttsx_torch.dsp.stft import mel_spectrogram

        results = {}
        au = self.cfg.audio
        # fixed analysis window: long recordings stream through windows
        # of one shape (main.py:156-295 >1 GB chunk processing, expressed
        # as static-shape windows instead of ffmpeg splits)
        win = self.max_frames * au.hop_length
        for spk in context.get("speaker_ids", []):
            wav_path = Path(context["output_dir"]) / "speakers" / f"{spk}.wav"
            if not wav_path.exists():
                continue
            wav, _ = read_wav(wav_path, au.sample_rate)
            f0_parts, en_parts, v_parts = [], [], []
            for off in range(0, max(len(wav), 1), win):
                part = wav[off:off + win]
                if len(part) < au.win_length:
                    break
                pad = win - len(part)
                if pad:
                    part = np.concatenate(
                        [part, np.zeros(pad, np.float32)])
                w = torch.as_tensor(part[None], device=self.device)
                f0c, enc, vc = extract_f0_energy(w, au)
                n_valid = (len(wav) - off) // au.hop_length
                f0_parts.append(f0c.cpu().numpy()[0][:n_valid])
                en_parts.append(enc.cpu().numpy()[0][:n_valid])
                v_parts.append(vc.cpu().numpy()[0][:n_valid])
            f0 = np.concatenate(f0_parts) if f0_parts else np.zeros(0)
            energy = np.concatenate(en_parts) if en_parts else np.zeros(0)
            voiced = np.concatenate(v_parts) if v_parts else np.zeros(0,
                                                                      bool)
            trend = {
                "f0": f0.round(2).tolist(),
                "energy": energy.round(5).tolist(),
                "voiced_ratio": float(voiced.mean()) if len(voiced) else 0.0,
            }
            if self.params is not None:
                if self._predictor is None:
                    from ttsx_torch.models.prosody import ProsodyPredictor
                    from ttsx_torch.weights import load_flax
                    self._predictor = load_flax(
                        ProsodyPredictor(self.cfg), self.params).to(
                            self.device).eval()
                head = torch.as_tensor(wav[None, :win], device=self.device)
                mel = mel_spectrogram(head, au)[:, :self.max_frames]
                with torch.no_grad():
                    feats = {k: v.cpu().numpy()
                             for k, v in self._predictor(mel).items()}
                trend["model_f0"] = feats["f0"][0].round(2).tolist()
                trend["speech_rate"] = float(feats["speech_rate"][0, 0])
                trend["pause_dur"] = float(feats["pause_dur"][0, 0])
                trend["mfcc"] = feats["mfcc"][0].round(3).tolist()
            d = speaker_dir(context, spk)
            write_json_atomic(d / "prosody_trend.json", trend)
            results[spk] = {"frames": len(trend["f0"])}
        return {"speakers": results}
