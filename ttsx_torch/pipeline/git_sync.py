"""Git-sync stage: job manifest + commit/push with retries and rollback.

Re-designs modules/git_sync/git_sync.py:17-91.

A copy of ``ttsx/pipeline/git_sync.py``, line for line (the port imports
nothing of ``ttsx``).
"""
from __future__ import annotations

import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

from ttsx_torch.pipeline.contracts import Stage, write_json_atomic, read_json


def _git(repo: Path, *args, check=True):
    return subprocess.run(["git", "-C", str(repo), *args],
                          capture_output=True, text=True, check=check)


def build_manifest(context: Dict) -> Dict:
    """Job manifest: totals, arc, slope, entropy (git_sync.py:22-42)."""
    out_dir = Path(context["output_dir"])
    arc = read_json(out_dir / "arc_classification.json", {})
    totals = {"n_speakers": len(context.get("speaker_ids", [])), "tags": 0}
    slopes, entropies = [], []
    for spk in context.get("speaker_ids", []):
        d = out_dir / "emotion_tags" / spk
        t2 = read_json(d / "tier2_tags.json", {"tags": []})["tags"]
        totals["tags"] += len(t2)
        log = read_json(d / "drift_log.json", {})
        if "confidence_slope" in log:
            slopes.append(log["confidence_slope"])
        if "emotion_entropy" in log:
            entropies.append(log["emotion_entropy"])
    return {
        "job_id": context.get("job_id"),
        "totals": totals,
        "arc_pattern": arc.get("pattern"),
        "mean_confidence_slope": (sum(slopes) / len(slopes)) if slopes else 0,
        "mean_emotion_entropy": (sum(entropies) / len(entropies))
        if entropies else 0,
        "timestamp": time.time(),
    }


class GitSyncStage(Stage):
    name = "git_sync"

    def __init__(self, repo_dir: Optional[str] = None, push: bool = False,
                 retries: int = 3):
        self.repo_dir = repo_dir
        self.push = push
        self.retries = retries

    def run(self, context: Dict) -> Dict:
        out_dir = Path(context["output_dir"])
        manifest = build_manifest(context)
        write_json_atomic(out_dir / "job_manifest.json", manifest)
        if not self.repo_dir:
            return {"manifest": manifest, "pushed": False}

        repo = Path(self.repo_dir)
        dest = repo / "jobs" / str(context.get("job_id", "job"))
        dest.mkdir(parents=True, exist_ok=True)
        for p in out_dir.glob("*.json"):
            shutil.copy2(p, dest / p.name)
        et = out_dir / "emotion_tags"
        if et.exists():
            shutil.copytree(et, dest / "emotion_tags", dirs_exist_ok=True)

        head = _git(repo, "rev-parse", "HEAD").stdout.strip()
        _git(repo, "add", "-A")
        _git(repo, "commit", "-m", f"job {context.get('job_id')} artifacts",
             check=False)
        commit = _git(repo, "rev-parse", "HEAD").stdout.strip()
        write_json_atomic(out_dir / "last_git_commit.json",
                          {"commit": commit, "previous": head})
        if not self.push:
            return {"manifest": manifest, "commit": commit, "pushed": False}

        # push with retries; hard-reset rollback on final failure
        # (git_sync.py:78-89)
        for attempt in range(self.retries):
            r = _git(repo, "push", check=False)
            if r.returncode == 0:
                return {"manifest": manifest, "commit": commit,
                        "pushed": True, "attempts": attempt + 1}
            time.sleep(1.0 * (attempt + 1))
        _git(repo, "reset", "--hard", head, check=False)
        return {"manifest": manifest, "pushed": False, "rolled_back": True,
                "status": "partial-failure"}
