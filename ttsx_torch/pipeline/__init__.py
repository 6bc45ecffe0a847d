"""The ingestion pipeline (``ttsx/pipeline``): the stage contract with
its locked JSON IO, the speaker diarizer (``ttsx_torch.pipeline.diarizer``)
and the observer pipeline's stages, orchestrator and trigger."""
from ttsx_torch.pipeline.contracts import (
    Stage, file_lock, write_json_atomic, read_json, speaker_dir)
from ttsx_torch.pipeline.sentiment import polarity_scores, vader_vector
from ttsx_torch.pipeline import emotion_utils
from ttsx_torch.pipeline.drift import DriftStage, detect_drift, savgol_smooth
from ttsx_torch.pipeline.alignment import AlignmentStage
from ttsx_torch.pipeline.tiers import Tier1Stage, Tier2Stage
from ttsx_torch.pipeline.anomaly import AnomalyStage, repetition_ratio
from ttsx_torch.pipeline.fingerprint import (
    FingerprintStage, ArcStage, kmeans_1d)
from ttsx_torch.pipeline.plot_map import PlotMapStage
from ttsx_torch.pipeline.dynamic_learning import (
    DynamicLearningStage, load_tagged_data, update_validation_set,
    update_rule_confidences, check_accuracy_drop)
from ttsx_torch.pipeline.git_sync import GitSyncStage, build_manifest
from ttsx_torch.pipeline.trigger import (
    JobQueue, TriggerWatcher, Worker, install_graceful_shutdown)
from ttsx_torch.pipeline.asr import (
    ASRService, TranscriptionStage, ProsodyExtractStage)
from ttsx_torch.pipeline.observer_ui import ReviewSession
from ttsx_torch.pipeline.orchestrator import (
    ObserverPipeline, watch, log_resources)
from ttsx_torch.pipeline import diarizer
from ttsx_torch.pipeline.diarizer import (
    DiarizerController, ReIDMemory, SliceEmbedder)
