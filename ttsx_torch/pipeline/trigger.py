"""Filesystem trigger watcher + job queue worker.

Re-designs modules/trigger/trigger.py:15-53 and the worker/status machine
of reference_encoder/main.py:405-416 — a polling watcher (watchdog-free)
for `*.ready` marker files, a queue-consuming worker thread, SIGINT/SIGTERM
graceful shutdown, and job status tracking
(queued/processing/done/partial-failure/failed).

A copy of ``ttsx/pipeline/trigger.py``, line for line (the port imports
nothing of ``ttsx``), with ``TriggerWatcher.wait``, which the port's
``main_observer --watch`` blocks on until a signal stops the watcher.
"""
from __future__ import annotations

import queue
import signal
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional


class JobQueue:
    def __init__(self):
        self.q: "queue.Queue[Dict]" = queue.Queue()
        self.status: Dict[str, str] = {}
        self._lock = threading.Lock()

    def enqueue(self, job: Dict):
        job_id = job["job_id"]
        with self._lock:
            self.status[job_id] = "queued"
        self.q.put(job)

    def set_status(self, job_id: str, status: str):
        with self._lock:
            self.status[job_id] = status

    def get_status(self, job_id: str) -> Optional[str]:
        with self._lock:
            return self.status.get(job_id)


class TriggerWatcher:
    """Polls a directory for `*.ready` markers; each marker names a wav to
    process (trigger.py watchdog handler, poll-based)."""

    def __init__(self, watch_dir: str, job_queue: JobQueue,
                 poll_s: float = 0.5):
        self.watch_dir = Path(watch_dir)
        self.job_queue = job_queue
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._seen: set = set()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                for marker in sorted(self.watch_dir.glob("*.ready")):
                    if marker in self._seen:
                        continue
                    self._seen.add(marker)
                    wav = marker.with_suffix("")
                    self.job_queue.enqueue({
                        "job_id": wav.stem,
                        "input_wav": str(wav),
                        "marker": str(marker)})
            except OSError:
                pass
            self._stop.wait(self.poll_s)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True once ``stop`` has been called; waits up to ``timeout``
        seconds for it."""
        return self._stop.wait(timeout)


class Worker:
    """Consumes the job queue; runs `process_fn(job)` and tracks status."""

    def __init__(self, job_queue: JobQueue, process_fn: Callable[[Dict], Dict]):
        self.job_queue = job_queue
        self.process_fn = process_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                job = self.job_queue.q.get(timeout=0.5)
            except queue.Empty:
                continue
            job_id = job["job_id"]
            self.job_queue.set_status(job_id, "processing")
            try:
                result = self.process_fn(job)
                status = result.get("status", "done") if isinstance(
                    result, dict) else "done"
                self.job_queue.set_status(
                    job_id, "done" if status == "ok" else status)
            except Exception:
                self.job_queue.set_status(job_id, "failed")
            finally:
                self.job_queue.q.task_done()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


def install_graceful_shutdown(*stoppables):
    """SIGINT/SIGTERM -> stop watchers/workers (trigger.py:33-53)."""
    def handler(signum, frame):
        for s in stoppables:
            s.stop()
    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)
