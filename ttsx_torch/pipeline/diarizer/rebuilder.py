"""Per-speaker audio reconstruction + artifacts
(``ttsx/pipeline/diarizer/rebuilder.py``; numpy, wavs written through
``ttsx_torch.data.dataset.write_wav``).

Re-designs hyper_diarizer/audio_rebuilder.py:35-168: per speaker,
concatenate slices with 100 ms silence, peak-normalize, write per-speaker
wav + intervals.json + summary.csv + RTTM + speaker_stats.json. Whisper
transcription and Demucs separation are external services (SURVEY §2.9)
pluggable via `asr` / `separate_fn`; without them the rebuild still emits
every artifact with empty text and unseparated overlap regions.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ttsx_torch.core.config import AudioConfig
from ttsx_torch.pipeline.contracts import write_json_atomic


def write_rttm(path: Path, job_id: str,
               segments: Sequence[Tuple[float, float, str]]):
    with open(path, "w") as f:
        for s, e, spk in segments:
            f.write(f"SPEAKER {job_id} 1 {s:.3f} {e - s:.3f} "
                    f"<NA> <NA> {spk} <NA> <NA>\n")


def reconstruct_audio(wav: np.ndarray, au: AudioConfig, out_dir: str | Path,
                      job_id: str,
                      slices: List[Tuple[float, float]],
                      speakers: List[str],
                      overlaps: Optional[List[Tuple]] = None,
                      asr=None,
                      separate_fn: Optional[Callable] = None,
                      silence_ms: float = 100.0,
                      overlap_speakers: Optional[List[Tuple]] = None
                      ) -> Dict:
    """Returns {speaker: wav_path}; writes all §2.3 rebuild artifacts."""
    from ttsx_torch.data.dataset import write_wav

    out_dir = Path(out_dir)
    spk_dir = out_dir / "speakers"
    spk_dir.mkdir(parents=True, exist_ok=True)
    sr = au.sample_rate
    silence = np.zeros(int(silence_ms / 1000 * sr), np.float32)

    by_spk: Dict[str, List[Tuple[float, float]]] = {}
    for (s, e), spk in zip(slices, speakers):
        by_spk.setdefault(spk, []).append((s, e))

    overlap_ranges = [(o[0], o[1]) for o in (overlaps or [])]
    paths: Dict[str, str] = {}
    stats: Dict[str, Dict] = {}
    all_rttm: List[Tuple[float, float, str]] = []

    for spk, segs in by_spk.items():
        parts: List[np.ndarray] = []
        intervals = []
        transcript_segments = []
        cursor = 0.0
        for s, e in sorted(segs):
            seg = wav[int(s * sr):int(e * sr)]
            in_overlap = any(o0 < e and o1 > s for o0, o1 in overlap_ranges)
            if in_overlap and separate_fn is not None:
                seg = separate_fn(seg, sr)  # Demucs-class vocal separation
            if asr is not None:
                res = asr.transcribe(seg, sr)
                text = " ".join(x.get("text", "")
                                for x in res.get("segments", [])).strip()
            else:
                text = ""
            parts.extend([seg, silence])
            intervals.append({"source_start": s, "source_end": e,
                              "output_start": round(cursor, 3),
                              "overlap": bool(in_overlap), "text": text})
            transcript_segments.append(
                {"start": s, "end": e, "text": text})
            cursor += (e - s) + silence_ms / 1000
            all_rttm.append((s, e, spk))
        merged = np.concatenate(parts) if parts else np.zeros(1, np.float32)
        peak = np.abs(merged).max() + 1e-8
        merged = merged / peak * 0.95  # peak-normalize
        wav_path = spk_dir / f"{spk}.wav"
        write_wav(wav_path, merged, sr)
        paths[spk] = str(wav_path)
        write_json_atomic(spk_dir / f"{spk}_intervals.json",
                          {"intervals": intervals})
        # per-speaker transcript for downstream tiers
        d = out_dir / "emotion_tags" / spk
        d.mkdir(parents=True, exist_ok=True)
        write_json_atomic(d / "transcript.json",
                          {"segments": transcript_segments})
        stats[spk] = {
            "n_slices": len(segs),
            "total_s": round(sum(e - s for s, e in segs), 3),
            "mean_slice_s": round(float(np.mean([e - s for s, e in segs])), 3),
        }

    write_json_atomic(out_dir / "speaker_stats.json", stats)
    # overlapped regions are MULTI-label: add an RTTM line for each
    # overlap speaker whose own slices don't already cover the span
    # (RTTM supports simultaneous speaker rows natively)
    for ov in overlap_speakers or []:
        s, e = float(ov[0]), float(ov[1])
        for spk in ov[2:4]:
            covered = any(o0 <= s and e <= o1
                          for o0, o1 in by_spk.get(spk, []))
            if not covered:
                all_rttm.append((s, e, spk))
    write_rttm(out_dir / f"{job_id}.rttm", job_id, sorted(all_rttm))
    with open(out_dir / "summary.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["speaker", "n_slices", "total_s", "mean_slice_s"])
        for spk, st in stats.items():
            w.writerow([spk, st["n_slices"], st["total_s"],
                        st["mean_slice_s"]])
    return paths
