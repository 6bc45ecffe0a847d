"""Offline hard-diarizer clustering from a checked-in embedding dump
(``ttsx/pipeline/diarizer/offline.py``).

``eval_results/diar_embs.npz`` holds the hard benchmark stream, its
ground truth and the reference's window embeddings; this module runs the
production post-embedding recipe on them — cluster -> smooth -> merge ->
stitch -> cross-speaker trim -> speech-mask clip -> DER — in numpy, so
it gives the same numbers on any machine.

Reference analog: hyper_diarizer/cli.py:179-188 evaluation path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def cluster_windows(wins: List[Tuple[float, float]], embs: np.ndarray,
                    wav: Optional[np.ndarray] = None, au=None,
                    merge_thresh: float = 0.75,
                    cluster_fn=None) -> Tuple[List, List[str]]:
    """Window embeddings -> (segments, speaker names).

    The production controller recipe at window granularity: NO
    tcn_context (it homogenizes window embeddings and collapses the
    eigengap count — controller.py), eigengap spectral clustering,
    causal label smoothing, prototype merge, same-speaker stitching,
    cross-speaker pad trim, then 2-means log-RMS speech-mask clipping
    when the wav is given (silence inside segments is pure strict-DER
    false alarm).
    """
    from ttsx_torch.pipeline.diarizer.cluster import (
        ReIDMemory, merge_clusters, spectral_cluster, stitch_segments)
    from ttsx_torch.pipeline.diarizer.controller import (
        trim_cross_speaker_overlaps)

    wins = [tuple(w) for w in wins]
    starts = np.asarray([s for s, _ in wins])
    labels = (cluster_fn(embs, starts) if cluster_fn is not None
              else spectral_cluster(embs))
    labels = ReIDMemory.smooth_labels(labels, starts, embs)
    if merge_thresh > 0:
        labels = merge_clusters(embs, labels, merge_thresh)
    segs, seg_labels, _ = stitch_segments(wins, labels, embs)
    speakers = [f"c{int(l)}" for l in seg_labels]
    segs = trim_cross_speaker_overlaps(segs, speakers)
    if wav is not None:
        from ttsx_torch.pipeline.diarizer.slicer import (
            clip_segments, speech_mask)
        runs = speech_mask(wav, au)
        segs, kept = clip_segments(segs, list(range(len(segs))), runs)
        speakers = [speakers[i] for i in kept]
    return segs, speakers


def evaluate_dump(dump_path: str, variant: str = "plain") -> Dict:
    """DER of the production offline recipe on a dump npz."""
    from ttsx_torch.core.config import AudioConfig
    from ttsx_torch.eval.metrics import diarization_error_rate

    D = np.load(dump_path, allow_pickle=True)
    truth = [(float(s), float(e), str(k)) for s, e, k in
             zip(D["truth_start"], D["truth_end"], D["truth_spk"])]
    au = AudioConfig(sample_rate=int(D["sr"]))
    segs, speakers = cluster_windows(
        [tuple(w) for w in D[f"win_{variant}"]], D[f"emb_{variant}"],
        wav=D["wav"], au=au)
    hyp = [(s, e, spk) for (s, e), spk in zip(segs, speakers)]
    return {
        "der": round(float(diarization_error_rate(truth, hyp)), 4),
        "der_collar": round(float(
            diarization_error_rate(truth, hyp, collar=0.25)), 4),
        "k": len(set(speakers)),
        "k_true": len({k for _, _, k in truth}),
        "n_segs": len(segs),
    }
