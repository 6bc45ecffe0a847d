"""Emotion rule table, grouping, and thresholds.

Re-designs modules/utils/emotion_utils.py:5-118: 31 rules over
{pos, neg, neu, prosody z-scores, keywords}, the reference's GROUP_MAP
into Negative/Neutral/Positive, and the tier thresholds
T1_AUTO .90 / T1_MIN .80 / T2_AUTO .90 / T2_MIN .65 / STD .30.

The label vocabulary is the reference's exact 31 names (emotion_utils.py:
5-91) so tier2_tags.json / learned_rules.json are drop-in comparable with
reference output. The rule *conditions* are our own: the reference mixes
raw units (pitch in Hz, speech rate in wpm) with z-scored energy; this
pipeline normalizes every prosody feature to a per-speaker z-score before
classification, so thresholds here live in z-space.

A copy of ``ttsx/pipeline/emotion_utils.py``, line for line (the port imports
nothing of ``ttsx``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

T1_AUTO = 0.90
T1_MIN = 0.80
T2_AUTO = 0.90
T2_MIN = 0.65
STD_REVIEW = 0.30


class Features(NamedTuple):
    pos: float = 0.0
    neg: float = 0.0
    neu: float = 0.0
    pitch: float = 0.0        # z-score of mean pitch
    energy: float = 0.0       # z-score of mean energy
    speech_rate: float = 0.0  # z-score
    pause: float = 0.0        # z-score of pause ratio
    pitch_var: float = 0.0    # z-score of pitch variability
    energy_var: float = 0.0   # z-score of energy variability
    keywords: frozenset = frozenset()


class Rule(NamedTuple):
    rule_id: str
    label: str
    fn: Callable[[Features], bool]
    # keyword gate as DATA (empty = purely prosodic rule): harnesses and
    # tests derive their word pools from here instead of hand-copying the
    # sets buried in the lambdas (which silently desynchronizes on edits)
    keywords: frozenset = frozenset()


def _krule(rule_id: str, label: str, cond: Callable[[Features], bool],
           *words: str) -> Rule:
    """Keyword-gated rule: fires when `cond` holds AND the slice mentions
    one of `words`; the word set is carried on the Rule as data."""
    k = frozenset(words)
    return Rule(rule_id, label,
                lambda f, _c=cond, _k=k: _c(f) and bool(f.keywords & _k),
                k)


# 31-emotion rule table using the reference's label vocabulary. First match
# wins: keyword-gated rules come before the purely prosodic ones within each
# sentiment group, and the bare "Neutral" rule is last (classify() also
# falls back to it when nothing fires).
RULES: List[Rule] = [
    # -- Negative (13) -----------------------------------------------------
    _krule("R01", "Fear", lambda f: f.neg > 0.5 and f.pitch_var > 0.5,
           "scared", "terrified", "afraid"),
    _krule("R02", "Despair", lambda f: f.neg > 0.6 and f.pitch < -0.4,
           "hopeless", "desperate", "despair"),
    _krule("R03", "Anxiety", lambda f: f.neg > 0.45 and f.pitch_var > 0.35,
           "worried", "nervous", "anxious"),
    _krule("R04", "Contempt", lambda f: f.neg > 0.4 and f.energy < -0.3,
           "disdain", "scorn", "contempt"),
    _krule("R05", "Disgust", lambda f: f.neg > 0.5 and f.energy_var > 0.35,
           "revolting", "gross", "disgusting"),
    _krule("R06", "Frustration",
           lambda f: f.neg > 0.45 and f.speech_rate > 0.35,
           "annoyed", "frustrated", "ugh"),
    _krule("R07", "Guilt", lambda f: f.neg > 0.4 and f.pause > 0.3,
           "sorry", "regret", "fault"),
    _krule("R08", "Irritation",
           lambda f: f.neg > 0.35 and f.pitch_var > 0.25,
           "irritated", "bothered", "annoying"),
    _krule("R09", "Jealousy", lambda f: f.neg > 0.4 and f.energy > 0.3,
           "envy", "jealous", "unfair"),
    _krule("R10", "Loneliness",
           lambda f: f.neg > 0.5 and f.speech_rate < -0.3,
           "alone", "isolated", "lonely"),
    _krule("R11", "Negative Surprise",
           lambda f: f.neg > 0.35 and f.pitch_var > 0.7,
           "shock", "shocked", "unexpected"),
    Rule("R12", "Anger", lambda f: f.neg > 0.55 and f.pitch > 0.45),
    Rule("R13", "Sadness", lambda f: f.neg > 0.6 and f.pitch < -0.25),
    # -- Positive (10) -----------------------------------------------------
    _krule("R14", "Amusement", lambda f: f.pos > 0.5 and f.energy_var > 0.35,
           "funny", "amused", "laugh", "haha"),
    _krule("R15", "Enthusiasm", lambda f: f.pos > 0.6 and f.pitch > 0.4,
           "excited", "enthusiastic", "awesome"),
    _krule("R16", "Gratitude",
           lambda f: f.pos > 0.55 and f.speech_rate < 0.2,
           "thankful", "grateful", "thank", "thanks"),
    _krule("R17", "Inspiration", lambda f: f.pos > 0.65 and f.energy > 0.4,
           "inspired", "motivated", "inspiring"),
    _krule("R18", "Love", lambda f: f.pos > 0.7 and f.pause < 0.2,
           "love", "affection", "darling"),
    _krule("R19", "Hope", lambda f: f.pos > 0.45 and f.pitch_var > 0.2,
           "hopeful", "optimistic", "hope"),
    _krule("R20", "Relief", lambda f: f.pos > 0.45 and f.energy_var < 0.1,
           "relieved", "eased", "relief"),
    _krule("R21", "Pleasant", lambda f: f.pos > 0.5 and f.pitch > 0.15,
           "pleasant", "nice", "lovely"),
    Rule("R22", "Happiness", lambda f: f.pos > 0.6 and f.energy > 0.5),
    Rule("R23", "Surprise", lambda f: f.pos > 0.5 and f.pitch_var > 0.5),
    # -- Neutral (8) ---------------------------------------------------------
    _krule("R24", "Boredom", lambda f: f.neu > 0.6 and f.energy < -0.5,
           "bored", "uninterested", "boring"),
    _krule("R25", "Concentration",
           lambda f: f.neu > 0.5 and f.speech_rate > 0.3,
           "focused", "attentive", "focus"),
    _krule("R26", "Flat narration",
           lambda f: f.neu > 0.7 and f.pitch_var < -0.5,
           "monotone", "flat"),
    _krule("R27", "Hesitant", lambda f: f.neu > 0.55 and f.pause > 0.4,
           "unsure", "hesitant", "um", "uh"),
    _krule("R28", "Matter-of-fact Informational tone",
           lambda f: f.neu > 0.6 and f.energy_var < -0.3,
           "factual", "informative"),
    _krule("R29", "Tired", lambda f: f.neu > 0.5 and f.energy < -0.7,
           "exhausted", "weary", "tired"),
    Rule("R30", "Calm", lambda f: f.neu > 0.55 and abs(f.energy) < 0.25
         and abs(f.pitch_var) < 0.3),
    # reference Neutral rule is conjunctive (neu > 0.7 AND low pitch
    # variability, emotion_utils.py:61) — NOT a catch-all; when nothing
    # fires, tier2 keeps the tier-1 sentiment label (tier2.py:126-136
    # `label = base_tag`), which classify() signals by returning None
    Rule("R31", "Neutral", lambda f: f.neu > 0.7 and f.pitch_var < 0.3),
]

# Reference GROUP_MAP (emotion_utils.py:95-107) verbatim: it routes
# auto-accepted JSON into Tier1 folders, so the mapping is a spec constant.
GROUP_MAP: Dict[str, str] = {
    "Anger": "Negative", "Anxiety": "Negative", "Contempt": "Negative",
    "Despair": "Negative", "Disgust": "Negative", "Fear": "Negative",
    "Frustration": "Negative", "Guilt": "Negative",
    "Irritation": "Negative", "Jealousy": "Negative",
    "Loneliness": "Negative", "Negative Surprise": "Negative",
    "Sadness": "Negative",
    "Boredom": "Neutral", "Calm": "Neutral", "Concentration": "Neutral",
    "Flat narration": "Neutral", "Hesitant": "Neutral",
    "Matter-of-fact Informational tone": "Neutral", "Neutral": "Neutral",
    "Tired": "Neutral",
    "Amusement": "Positive", "Enthusiasm": "Positive",
    "Gratitude": "Positive", "Happiness": "Positive", "Hope": "Positive",
    "Inspiration": "Positive", "Love": "Positive", "Pleasant": "Positive",
    "Relief": "Positive", "Surprise": "Positive",
}

EMOTION_LABELS = [r.label for r in RULES]


def classify(features: Features):
    """First matching rule, or None when no rule fires (the caller keeps
    the tier-1 base tag, reference tier2.py:126-136). Confidence comes
    from tier logic, not here."""
    for rule in RULES:
        if rule.fn(features):
            return rule
    return None
