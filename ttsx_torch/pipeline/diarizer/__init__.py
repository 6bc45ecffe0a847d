"""The speaker diarizer (``ttsx/pipeline/diarizer``): VAD slicer, batched
slice embedder, clustering and re-identification, overlap detection
(heuristic or the learned screen), the GNN clusterer, per-speaker
rebuild, the controller and the offline recipe."""
from ttsx_torch.pipeline.diarizer.slicer import dynamic_slice, vad_probabilities
from ttsx_torch.pipeline.diarizer.embedding import SliceEmbedder
from ttsx_torch.pipeline.diarizer.cluster import (
    time_aware_sim, temporal_cluster, GreedyModularityClusterer,
    KMeansClusterer, ReIDMemory, ReIDCallback, PairCollector, WandBCallback)
from ttsx_torch.pipeline.diarizer.overlap import detect_overlaps, spectral_flux
from ttsx_torch.pipeline.diarizer.rebuilder import reconstruct_audio, write_rttm
from ttsx_torch.pipeline.diarizer.controller import DiarizerController
from ttsx_torch.pipeline.diarizer.reid import ReIDSystem
from ttsx_torch.pipeline.diarizer.gnn import GNNClusterer
