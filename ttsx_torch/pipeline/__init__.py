"""The ingestion pipeline (``ttsx/pipeline``), as far as it is ported:
the stage contract with its locked JSON IO, and the speaker diarizer
(``ttsx_torch.pipeline.diarizer``)."""
from ttsx_torch.pipeline.contracts import (
    Stage, file_lock, write_json_atomic, read_json, speaker_dir)
from ttsx_torch.pipeline import diarizer
from ttsx_torch.pipeline.diarizer import (
    DiarizerController, ReIDMemory, SliceEmbedder)
