"""Pipeline stage contract + locked JSON artifact IO (a copy of
``ttsx/pipeline/contracts.py``, which the port does not import).

Reference: reference_encoder/main.py §2.4 — every stage is
`run(context) -> dict` where context = {job_id, input_wav, output_dir,
speaker_ids, config, ...}; stages communicate through JSON files per
speaker under output_dir/emotion_tags/<spk>/, protected by file locks and
atomic tmp+rename writes (anomaly.py:62-65, dynamic_learning.py:30-35).
"""
from __future__ import annotations

import fcntl
import json
import os
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional


@contextmanager
def file_lock(path: str | Path, timeout: float = 30.0, exclusive: bool = True):
    """portalocker-equivalent advisory lock via fcntl."""
    lock_path = Path(str(path) + ".lock")
    lock_path.parent.mkdir(parents=True, exist_ok=True)
    f = open(lock_path, "w")
    flags = fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH
    deadline = time.time() + timeout
    while True:
        try:
            fcntl.flock(f, flags | fcntl.LOCK_NB)
            break
        except BlockingIOError:
            if time.time() > deadline:
                f.close()
                raise TimeoutError(f"lock timeout on {path}")
            time.sleep(0.05)
    try:
        yield
    finally:
        fcntl.flock(f, fcntl.LOCK_UN)
        f.close()


def write_json_atomic(path: str | Path, data: Any) -> None:
    """tmp + os.replace atomic write under the file lock."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with file_lock(path):
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def read_json(path: str | Path, default: Any = None) -> Any:
    path = Path(path)
    if not path.exists():
        return default
    with file_lock(path, exclusive=False):
        return json.loads(path.read_text())


def speaker_dir(context: Dict, speaker: str) -> Path:
    d = Path(context["output_dir"]) / "emotion_tags" / speaker
    d.mkdir(parents=True, exist_ok=True)
    return d


class Stage:
    """Base pipeline stage; subclasses implement run(context) -> dict."""
    name = "stage"

    def run(self, context: Dict) -> Dict:
        raise NotImplementedError

    def __call__(self, context: Dict) -> Dict:
        t0 = time.perf_counter()
        try:
            out = self.run(context) or {}
            out.setdefault("status", "ok")
        except Exception as e:  # defensive per-stage failure (SURVEY §5.3)
            out = {"status": "failed", "error": f"{type(e).__name__}: {e}"}
        out["stage"] = self.name
        out["wall_time_s"] = time.perf_counter() - t0
        times = context.setdefault("step_times", {})
        times[self.name] = out["wall_time_s"]
        return out
