"""Observer ingestion pipeline orchestrator
(``ttsx/pipeline/orchestrator.py``).

Re-designs reference_encoder/main.py:67-154 pipeline():
  diarize input wav -> per-speaker wavs -> prosody + transcription ->
  drift -> alignment -> tier1 -> tier2 -> anomaly -> fingerprint -> arc ->
  plot_map -> observer report -> dynamic learning -> git sync,
with per-stage step timing, defensive per-stage failure isolation
(SURVEY §5.3), and job status (queued/processing/done/partial-failure/
failed). Resource logging (main.py:49-65) uses psutil when available.

The device work (the diarizer's slicer and encoder, the energy VAD, f0 /
energy and the prosody predictor) runs on the pipeline's ``device``
(default ``"cuda"``); the stages between are numpy on the host. Three
departures from the reference:

* ``log_resources`` reads ``torch.cuda.memory_allocated`` of a CUDA
  device, and an error from that read is raised (the reference reads
  jax's device stats and drops any error); the snapshots, one before
  the job and one after each stage, go into the job summary as
  ``resources`` (the reference collects them and writes them nowhere);
* the pipeline keeps one handler on its logger, moved to each job's
  ``pipeline.log`` (``utils.logs.LogFile``), where the reference attaches
  one per job directory and leaves them open, so a watcher piles them up;
* ``prosody_cfg`` goes to the prosody stage with ``prosody_params``: the
  reference passes the weights alone, so its stage builds
  ``ProsodyConfig()`` (8 norm groups, the normalized mel), which is not
  the config the zoo's predictor was trained in (4 groups, the
  unnormalized mel); its tree loads into it without an error and
  computes something else. A ``ProsodyPredictor`` passed as
  ``prosody_params`` brings its own config.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from ttsx_torch.core.config import AudioConfig, ProsodyConfig
from ttsx_torch.core.device import resolve_device
from ttsx_torch.pipeline.contracts import write_json_atomic
from ttsx_torch.pipeline.diarizer.controller import DiarizerController
from ttsx_torch.pipeline.asr import (ASRService, TranscriptionStage,
                                     ProsodyExtractStage)
from ttsx_torch.pipeline.drift import DriftStage
from ttsx_torch.pipeline.alignment import AlignmentStage
from ttsx_torch.pipeline.tiers import Tier1Stage, Tier2Stage
from ttsx_torch.pipeline.anomaly import AnomalyStage
from ttsx_torch.pipeline.fingerprint import FingerprintStage, ArcStage
from ttsx_torch.pipeline.plot_map import PlotMapStage
from ttsx_torch.pipeline.dynamic_learning import DynamicLearningStage
from ttsx_torch.pipeline.git_sync import GitSyncStage
from ttsx_torch.pipeline.observer_ui import ReviewSession
from ttsx_torch.utils.logs import LogFile

log = logging.getLogger("ttsx_torch.pipeline")


def log_resources(device=None) -> Dict:
    """RAM/CPU snapshot (main.py:49-65), and the bytes allocated on
    ``device`` when it is a CUDA device."""
    out: Dict = {"time": time.time()}
    try:
        import psutil
    except ImportError:
        psutil = None
    if psutil is not None:
        out["ram_gb"] = psutil.virtual_memory().used / 1e9
        out["cpu_pct"] = psutil.cpu_percent(interval=None)
    if device is not None and torch.device(device).type == "cuda":
        out["device_bytes_in_use"] = torch.cuda.memory_allocated(device)
    return out


class ObserverPipeline:
    def __init__(self, au: Optional[AudioConfig] = None,
                 diarizer: Optional[DiarizerController] = None,
                 asr: Optional[ASRService] = None,
                 prosody_params=None,
                 git_repo: Optional[str] = None,
                 prosody_cfg: Optional[ProsodyConfig] = None,
                 device="cuda"):
        self.au = au or AudioConfig()
        self.device = resolve_device(device)
        self.diarizer = diarizer or DiarizerController(self.au,
                                                       device=self.device)
        self.asr = asr or ASRService(audio=self.au, device=self.device)
        self.stages = [
            ProsodyExtractStage(prosody_cfg, prosody_params,
                                device=self.device),
            TranscriptionStage(self.asr),
            DriftStage(),
            AlignmentStage(),
            Tier1Stage(),
            Tier2Stage(),
            AnomalyStage(),
            FingerprintStage(),
            ArcStage(),
            PlotMapStage(),
            DynamicLearningStage(),
            GitSyncStage(git_repo),
        ]
        self._log = LogFile(log)

    def run_job(self, input_wav: str, output_dir: str,
                job_id: Optional[str] = None) -> Dict:
        job_id = job_id or Path(input_wav).stem
        out_dir = Path(output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        # bounded run log for watcher deployments (ref main.py's
        # RotatingFileHandler intent): the pipeline's one handler
        self._log.point(out_dir / "pipeline.log")
        context: Dict = {
            "job_id": job_id,
            "input_wav": input_wav,
            "output_dir": str(out_dir),
            "speaker_ids": [],
            "step_times": {},
            "resources": [log_resources(self.device)],
        }
        status = "done"

        # 1) diarize + rebuild per-speaker wavs (+ transcripts if asr text)
        t0 = time.perf_counter()
        dia = self.diarizer.diarize_single(input_wav, str(out_dir),
                                           asr=self.asr)
        context["step_times"]["diarize"] = time.perf_counter() - t0
        if not dia:
            status = "partial-failure"
        context["speaker_ids"] = sorted(set(dia.get("speakers", [])))

        # 2) sequential JSON-dataflow stages
        results = {}
        for stage in self.stages:
            out = stage(context)
            results[stage.name] = out
            if out.get("status") == "failed":
                log.warning("stage %s failed: %s", stage.name,
                            out.get("error"))
                status = "partial-failure"
            context["resources"].append(log_resources(self.device))

        # 3) observer static report
        try:
            ReviewSession(str(out_dir)).html_report(
                str(out_dir / "observer_report.html"))
        except Exception as e:
            log.warning("observer report failed: %s", e)
            status = "partial-failure"

        write_json_atomic(out_dir / "step_times.json",
                          context["step_times"])
        summary = {"job_id": job_id, "status": status,
                   "speakers": context["speaker_ids"],
                   "stages": {k: v.get("status") for k, v in results.items()},
                   "step_times": context["step_times"],
                   "resources": context["resources"]}
        write_json_atomic(out_dir / "job_summary.json", summary)
        return summary


def watch(watch_dir: str, output_root: str, poll_s: float = 0.5,
          **kwargs):
    """--watch mode: trigger watcher + worker loop (main.py:419-441),
    the watcher polling every ``poll_s`` seconds (the reference's 0.5).
    ``kwargs`` build the ``ObserverPipeline`` (``device`` among them).
    Replaces the process's SIGINT / SIGTERM handlers, so call it from the
    main thread."""
    from ttsx_torch.pipeline.trigger import (JobQueue, TriggerWatcher,
                                             Worker,
                                             install_graceful_shutdown)
    pipe = ObserverPipeline(**kwargs)
    q = JobQueue()

    def process(job):
        return pipe.run_job(job["input_wav"],
                            str(Path(output_root) / job["job_id"]),
                            job["job_id"])

    watcher = TriggerWatcher(watch_dir, q, poll_s=poll_s)
    worker = Worker(q, process)
    install_graceful_shutdown(watcher, worker)
    watcher.start()
    worker.start()
    return watcher, worker, q
