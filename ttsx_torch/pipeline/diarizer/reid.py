"""Thin ReID wrapper: memory re-id + overlap detection under the legacy
`memory.update` API (``ttsx/pipeline/diarizer/reid.py``); the overlap
heuristic's STFT runs on ``device``."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ttsx_torch.core.config import AudioConfig
from ttsx_torch.pipeline.diarizer.cluster import ReIDMemory
from ttsx_torch.pipeline.diarizer.overlap import detect_overlaps


class ReIDSystem:
    def __init__(self, memory: Optional[ReIDMemory] = None,
                 au: Optional[AudioConfig] = None, device="cuda"):
        self.memory = memory or ReIDMemory()
        self.au = au or AudioConfig()
        self.device = device

    def identify(self, cluster_embs: Dict[int, np.ndarray]):
        return self.memory.re_id(cluster_embs)

    def update(self, speaker: str, emb: np.ndarray):
        self.memory.update(speaker, emb)

    def overlaps(self, wav: np.ndarray, slices: List[Tuple[float, float]],
                 labels: np.ndarray, embs: np.ndarray):
        return detect_overlaps(wav, self.au, slices, labels, embs,
                               device=self.device)
