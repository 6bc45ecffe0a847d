"""Dynamic-learning stage: accept/reject tallies, stratified validation-set
refresh, EMA rule-confidence updates, accuracy-drop alerts.

Re-designs modules/utils/dynamic_learning.py:19-138.

A copy of ``ttsx/pipeline/dynamic_learning.py``, line for line (the port imports
nothing of ``ttsx``).
"""
from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np

from ttsx_torch.pipeline.contracts import Stage, write_json_atomic, read_json


def load_tagged_data(output_dir: str | Path) -> List[Dict]:
    """Scan all tier1_tags.json under emotion_tags/ (dynamic_learning.py:19)."""
    out = []
    root = Path(output_dir) / "emotion_tags"
    if not root.exists():
        return out
    for p in sorted(root.glob("*/tier1_tags.json")):
        tags = read_json(p, {"tags": []})["tags"]
        for t in tags:
            out.append({**t, "speaker": p.parent.name})
    return out


def update_validation_set(output_dir: str | Path, items: List[Dict],
                          frac: float = 0.05, cap: int = 500,
                          seed: int = 0) -> Dict:
    """Stratified 5% (cap 500) refresh, atomic write
    (dynamic_learning.py:76-104)."""
    rng = np.random.default_rng(seed)
    by_label: Dict[str, List[Dict]] = defaultdict(list)
    for it in items:
        by_label[it.get("label", "neutral")].append(it)
    target = min(cap, max(1, int(len(items) * frac))) if items else 0
    picked: List[Dict] = []
    labels = sorted(by_label)
    for lbl in labels:
        n = max(1, int(round(target * len(by_label[lbl]) / max(len(items), 1))))
        pool = by_label[lbl]
        idx = rng.choice(len(pool), size=min(n, len(pool)), replace=False)
        picked.extend(pool[i] for i in idx)
    val = {"items": picked[:cap], "n_total": len(items)}
    write_json_atomic(Path(output_dir) / "validation_set.json", val)
    return val


def update_rule_confidences(output_dir: str | Path, tally: Dict[str, Dict],
                            alpha: float = 0.9) -> Dict:
    """EMA (alpha=0.9) per-rule confidence updates
    (dynamic_learning.py:106-124)."""
    path = Path(output_dir) / "learned_confidences.json"
    learned = read_json(path, {})
    for rule_id, t in tally.items():
        total = t.get("accept", 0) + t.get("reject", 0)
        if not total:
            continue
        acc = t["accept"] / total
        prev = learned.get(rule_id, acc)
        learned[rule_id] = alpha * prev + (1 - alpha) * acc
    write_json_atomic(path, learned)
    return learned


def check_accuracy_drop(output_dir: str | Path, current_acc: float,
                        drop_thresh: float = 0.05) -> Dict:
    """>5% accuracy-drop alert vs the stored history
    (dynamic_learning.py:126-138)."""
    path = Path(output_dir) / "accuracy_history.json"
    hist = read_json(path, {"history": []})
    prev = hist["history"][-1] if hist["history"] else None
    alert = prev is not None and (prev - current_acc) > drop_thresh
    hist["history"].append(current_acc)
    hist["alert"] = bool(alert)
    write_json_atomic(path, hist)
    return {"alert": alert, "current": current_acc, "previous": prev}


class DynamicLearningStage(Stage):
    name = "dynamic_learning"

    def run(self, context: Dict) -> Dict:
        out_dir = context["output_dir"]
        items = load_tagged_data(out_dir)
        # accept/reject tallies from statuses + human corrections
        corrections = read_json(Path(out_dir) / "learned_rules.json", {})
        tally: Dict[str, Dict] = defaultdict(lambda: {"accept": 0,
                                                      "reject": 0})
        n_accept = 0
        for spk in context.get("speaker_ids", []):
            d = Path(out_dir) / "emotion_tags" / spk
            for t in read_json(d / "tier2_tags.json", {"tags": []})["tags"]:
                rid = t.get("rule_id", "R31")
                corrected = corrections.get(spk, {}).get(str(t.get("start")))
                if corrected and corrected.get("label") != t["label"]:
                    tally[rid]["reject"] += 1
                else:
                    tally[rid]["accept"] += 1
                    n_accept += 1
        total = sum(v["accept"] + v["reject"] for v in tally.values())
        acc = n_accept / total if total else 1.0
        val = update_validation_set(out_dir, items)
        learned = update_rule_confidences(out_dir, dict(tally))
        drop = check_accuracy_drop(out_dir, acc)
        return {"n_items": len(items), "accuracy": acc,
                "validation_size": len(val["items"]),
                "n_rules_updated": len(learned), "alert": drop["alert"]}
