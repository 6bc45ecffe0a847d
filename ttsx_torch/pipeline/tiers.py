"""Tier-1 sentiment tagging and Tier-2 emotion refinement stages.

Re-designs modules/tier1/tier1.py:13-111 and modules/tier2/tier2.py:25-197:
  tier1: per-slice sentiment -> pos/neg/neutral with auto-accept /
         needs-review / force-manual statuses; histogram rebalance caps
         neutral at 50%.
  tier2: negation-aware refinement through the 31-emotion rule table,
         per-slice speaker-embedding running-mean cosine ("ESR") score,
         confidence boost by drift + sentiment amplitude, thresholds
         T2_AUTO .90 / T2_MIN .65, std>.30 forces review.

A copy of ``ttsx/pipeline/tiers.py``, line for line (the port imports
nothing of ``ttsx``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ttsx_torch.pipeline.contracts import Stage, speaker_dir, write_json_atomic, read_json
from ttsx_torch.pipeline.sentiment import polarity_scores
from ttsx_torch.pipeline import emotion_utils as EU


def _status(conf: float, auto: float, min_t: float) -> str:
    if conf >= auto:
        return "auto-accept"
    if conf >= min_t:
        return "needs-review"
    return "force-manual"


class Tier1Stage(Stage):
    name = "tier1"

    def run(self, context: Dict) -> Dict:
        results = {}
        for spk in context.get("speaker_ids", []):
            d = speaker_dir(context, spk)
            transcript = read_json(d / "transcript.json", {"segments": []})
            tags = []
            for seg in transcript.get("segments", []):
                s = polarity_scores(seg.get("text", ""))
                comp = s["compound"]
                if comp >= 0.05:
                    label = "positive"
                    conf = min(1.0, 0.5 + abs(comp))
                elif comp <= -0.05:
                    label = "negative"
                    conf = min(1.0, 0.5 + abs(comp))
                else:
                    label = "neutral"
                    conf = s["neu"]
                tags.append({
                    "start": seg.get("start", 0.0),
                    "end": seg.get("end", 0.0),
                    "text": seg.get("text", ""),
                    "label": label,
                    "confidence": round(conf, 3),
                    "scores": s,
                    "status": _status(conf, EU.T1_AUTO, EU.T1_MIN),
                })
            tags = self._rebalance(tags)
            write_json_atomic(d / "tier1_tags.json", {"tags": tags})
            results[spk] = {"n": len(tags)}
        return {"speakers": results}

    @staticmethod
    def _rebalance(tags: List[Dict]) -> List[Dict]:
        """Cap neutral at 50%: flip the most polarized neutrals
        (tier1.py histogram rebalance)."""
        if not tags:
            return tags
        neutral = [t for t in tags if t["label"] == "neutral"]
        if len(neutral) <= len(tags) * 0.5:
            return tags
        excess = len(neutral) - int(len(tags) * 0.5)
        neutral.sort(key=lambda t: -abs(t["scores"]["compound"]))
        for t in neutral[:excess]:
            comp = t["scores"]["compound"]
            t["label"] = "positive" if comp > 0 else "negative"
            t["status"] = "needs-review"
        return tags


NEGATION_TOKENS = EU and {"not", "no", "never", "n't", "without", "hardly"}


def invert_if_negated(text: str, scores: Dict) -> Dict:
    """spaCy/negspacy-equivalent heuristic: swap pos/neg when a negation
    token appears OUTSIDE the lexicon scorer's 3-word pre-valence window
    (tier2.py negation inversion). The sentiment scorer already inverts
    valence for negations directly preceding a sentiment word
    (sentiment.py:78-81); re-flipping those would undo the correct
    handling — measured as a 9-point group-accuracy loss in
    ttsx/eval/rule_calibration.py before this guard."""
    from ttsx_torch.pipeline.sentiment import LEXICON, _WORD_RE
    # MUST tokenize exactly like polarity_scores (sentiment.py:61) — with
    # text.split(), sentence-final punctuation ("safe.") hides the
    # sentiment word from the handled-window check and the scores get
    # double-flipped on ordinary punctuated transcripts
    words = _WORD_RE.findall(text.lower())
    neg_at = [i for i, w in enumerate(words)
              if w in NEGATION_TOKENS or w.endswith("n't")]
    if not neg_at:
        return scores
    handled = {i for j, w in enumerate(words) if w in LEXICON
               for i in (j - 1, j - 2, j - 3)}
    if all(i in handled for i in neg_at):
        return scores
    flipped = dict(scores)
    flipped["pos"], flipped["neg"] = scores["neg"], scores["pos"]
    flipped["compound"] = -scores["compound"]
    return flipped


def contradiction_score(text: str) -> float:
    """Stanza-equivalent heuristic: 'but/however/although' mid-sentence
    signals a contradiction (tier2.py contradiction check)."""
    from ttsx_torch.pipeline.sentiment import _WORD_RE
    words = _WORD_RE.findall(text.lower())
    pivots = sum(1 for w in words if w in
                 ("but", "however", "although", "yet", "except"))
    return min(1.0, pivots * 0.5)


def slice_prosody_features(trend: Dict, tags: List[Dict],
                           frame_rate: float) -> List[Dict[str, float]]:
    """Per-slice prosody z-features from prosody_trend.json frame series.

    Reference tier2.py:80-84,119-134 z-scores f0/energy over the whole
    recording and means them over each slice's [start, end) frames. This
    adds pitch/energy variability and pause (unvoiced-ratio) / speech-rate
    z-scores across slices so the full rule table is live."""
    f0 = np.asarray(trend.get("f0", []), np.float64)
    en = np.asarray(trend.get("energy", []), np.float64)
    n = min(len(f0), len(en))
    f0, en = f0[:n], en[:n]
    voiced = f0 > 0
    if voiced.any():
        f0_z = np.zeros(n)
        f0_z[voiced] = ((f0[voiced] - f0[voiced].mean())
                        / (f0[voiced].std() + 1e-6))
    else:
        f0_z = np.zeros(n)
    en_z = (en - en.mean()) / (en.std() + 1e-6) if n else en
    rows = []
    for tag in tags:
        si = int(tag.get("start", 0.0) * frame_rate)
        ei = max(si + 1, int(tag.get("end", 0.0) * frame_rate))
        si, ei = min(si, n), min(ei, n)
        if ei <= si:
            rows.append(dict(pitch=0.0, energy=0.0, pitch_var=0.0,
                             energy_var=0.0, pause=0.0, speech_rate=0.0))
            continue
        sl_f0, sl_en, sl_v = f0_z[si:ei], en_z[si:ei], voiced[si:ei]
        dur = max((tag.get("end", 0.0) - tag.get("start", 0.0)), 1e-3)
        rows.append(dict(
            pitch=float(sl_f0[sl_v].mean()) if sl_v.any() else 0.0,
            energy=float(sl_en.mean()),
            pitch_var=float(sl_f0[sl_v].std()) if sl_v.sum() > 1 else 0.0,
            energy_var=float(sl_en.std()),
            pause=float(1.0 - sl_v.mean()),
            speech_rate=len(tag.get("text", "").split()) / dur))
    # variability / pause / rate live in across-slice z-space (the rule
    # thresholds are z-valued); mean pitch/energy are already recording-z
    if rows:
        for k in ("pitch_var", "energy_var", "pause", "speech_rate"):
            v = np.asarray([r[k] for r in rows])
            z = (v - v.mean()) / (v.std() + 1e-6)
            for r, zv in zip(rows, z):
                r[k] = float(zv)
    return rows


def _trend_usable(trend: Dict) -> bool:
    """True if prosody_trend.json carries usable frame series. A file
    that exists but has empty/missing f0 or energy must still route to
    the drift-delta fallback — gating on mere presence would silently
    zero every pitch/energy rule feature."""
    return min(len(trend.get("f0", []) or []),
               len(trend.get("energy", []) or [])) > 0


class Tier2Stage(Stage):
    name = "tier2"

    def __init__(self, embed_fn=None, emotion_fn=None, frame_rate=None):
        # embed_fn(wav_slice | text) -> np.ndarray speaker embedding, used
        # for the running-mean cosine ESR score; None -> ESR neutral 0.5
        self.embed_fn = embed_fn
        # emotion_fn(vader[4], prosody_vec[19]) -> probs[6]: the trained
        # EmotionClassifier + EmotionWeightLearner blend (prosody3/
        # assign_emotion_tags.py); None -> rule table only
        self.emotion_fn = emotion_fn
        if frame_rate is None:
            from ttsx_torch.core.config import AudioConfig
            au = AudioConfig()
            frame_rate = au.sample_rate / au.hop_length
        self.frame_rate = float(frame_rate)

    def run(self, context: Dict) -> Dict:
        results = {}
        for spk in context.get("speaker_ids", []):
            d = speaker_dir(context, spk)
            t1 = read_json(d / "tier1_tags.json", {"tags": []})["tags"]
            drift = read_json(d / "drift_vector.json", {})
            trend = read_json(d / "prosody_trend.json", {})
            pros = slice_prosody_features(trend, t1, self.frame_rate)
            trend_usable = _trend_usable(trend)
            events = drift.get("events", [])
            drift_conf = (np.mean([e["confidence"] for e in events])
                          if events else 0.0)
            deltas = np.asarray(drift.get("deltas", []), np.float64)
            running_emb: Optional[np.ndarray] = None
            out = []
            for i, tag in enumerate(t1):
                scores = invert_if_negated(tag["text"], tag["scores"])
                contra = contradiction_score(tag["text"])
                p = pros[i]
                if not trend_usable and len(deltas):
                    # no usable prosody_trend.json: fall back to drift-delta z
                    j = min(i, len(deltas) - 1)
                    z = float((deltas[j] - deltas.mean())
                              / (deltas.std() + 1e-6))
                    p = dict(p, pitch=z, energy=z)
                feats = EU.Features(
                    pos=scores["pos"], neg=scores["neg"], neu=scores["neu"],
                    pitch=p["pitch"], energy=p["energy"],
                    speech_rate=p["speech_rate"], pause=p["pause"],
                    pitch_var=p["pitch_var"], energy_var=p["energy_var"],
                    keywords=frozenset(tag["text"].lower().split()))
                rule = EU.classify(feats)
                if rule is not None:
                    label, group, rule_id = (rule.label,
                                             EU.GROUP_MAP[rule.label],
                                             rule.rule_id)
                else:
                    # no rule fired: keep the tier-1 base tag
                    # (reference tier2.py:126-136 `label = base_tag`)
                    label = tag["label"]
                    group = {"positive": "Positive", "negative": "Negative",
                             "neutral": "Neutral"}[label]
                    rule_id = "base"
                model_label = None
                if self.emotion_fn is not None:
                    vader = np.asarray([scores["pos"], scores["neg"],
                                        scores["neu"], scores["compound"]])
                    pvec = np.concatenate([
                        [p["pitch"], p["energy"], p["pitch_var"],
                         p["energy_var"], p["speech_rate"], p["pause"]],
                        np.zeros(13)])[:19]
                    probs = np.asarray(self.emotion_fn(vader, pvec))
                    from ttsx_torch.models.prosody import EMOTIONS
                    model_label = EMOTIONS[int(np.argmax(probs))]

                # ESR: cosine of slice embedding vs running mean
                esr = 0.5
                if self.embed_fn is not None:
                    emb = np.asarray(self.embed_fn(tag["text"]), np.float64)
                    emb = emb / (np.linalg.norm(emb) + 1e-8)
                    if running_emb is None:
                        running_emb = emb
                    else:
                        esr = float(np.dot(emb, running_emb)
                                    / (np.linalg.norm(running_emb) + 1e-8))
                        running_emb = 0.9 * running_emb + 0.1 * emb
                        running_emb /= np.linalg.norm(running_emb) + 1e-8

                conf = tag["confidence"]
                conf = conf * (1.0 - 0.3 * contra)
                conf = min(1.0, conf + 0.1 * drift_conf
                           + 0.1 * abs(scores["compound"]))
                entry = {
                    "start": tag["start"], "end": tag["end"],
                    "text": tag["text"],
                    "label": label,
                    "group": group,
                    "rule_id": rule_id,
                    "confidence": round(float(conf), 3),
                    "esr_score": round(float(esr), 3),
                    "status": _status(conf, EU.T2_AUTO, EU.T2_MIN),
                }
                if model_label is not None:
                    entry["model_label"] = model_label
                out.append(entry)
            # high variance forces review (tier2.py std>0.30)
            if out:
                confs = np.asarray([t["confidence"] for t in out])
                if confs.std() > EU.STD_REVIEW:
                    for t in out:
                        if t["status"] == "auto-accept":
                            t["status"] = "needs-review"
            write_json_atomic(d / "tier2_tags.json", {"tags": out})
            results[spk] = {"n": len(out)}
        return {"speakers": results}
