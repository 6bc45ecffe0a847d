"""Lexicon sentiment scorer — dependency-free VADER-equivalent.

The reference leans on vaderSentiment/TextBlob (modules/tier1/tier1.py);
neither is baked into this image, so the pipeline ships its own
valence-lexicon scorer with the same output contract:
{"pos": p, "neg": n, "neu": u, "compound": c}, p+n+u == 1.
Negation flipping and intensifier boosting follow the VADER heuristics.

A copy of ``ttsx/pipeline/sentiment.py``, line for line (the port imports
nothing of ``ttsx``).
"""
from __future__ import annotations

import math
import re
from typing import Dict

# compact valence lexicon (scores in [-4, 4], VADER convention)
LEXICON: Dict[str, float] = {
    # positive
    "good": 1.9, "great": 3.1, "wonderful": 2.7, "amazing": 2.8,
    "love": 3.2, "loved": 2.9, "happy": 2.7, "joy": 2.8, "glad": 2.0,
    "excellent": 2.7, "best": 3.2, "beautiful": 2.9, "nice": 1.8,
    "fantastic": 2.6, "awesome": 3.1, "hope": 1.9, "hopeful": 2.3,
    "excited": 2.3, "thrilled": 2.8, "proud": 2.2, "thank": 1.6,
    "thanks": 1.9, "grateful": 2.3, "relieved": 1.7, "calm": 1.3,
    "perfect": 2.7, "win": 2.4, "won": 2.7, "smile": 1.7, "laugh": 2.3,
    "funny": 1.9, "delighted": 2.9, "brilliant": 2.8, "safe": 1.2,
    "warm": 1.2, "friend": 1.9, "peace": 2.5, "sweet": 1.8,
    # negative
    "bad": -2.5, "terrible": -2.1, "awful": -2.0, "horrible": -2.5,
    "hate": -2.7, "hated": -2.9, "sad": -2.1, "angry": -2.3,
    "furious": -2.9, "worst": -3.1, "fear": -1.9, "afraid": -2.2,
    "scared": -2.2, "terrified": -3.0, "cry": -2.0, "crying": -2.2,
    "pain": -2.3, "hurt": -2.4, "die": -2.9, "dead": -3.0, "death": -2.9,
    "kill": -3.2, "lost": -1.3, "lose": -1.6, "alone": -1.0,
    "lonely": -2.2, "betrayed": -2.8, "betrayal": -2.7, "broken": -2.1,
    "wrong": -1.6, "fail": -2.3, "failed": -2.4, "failure": -2.5,
    "disgusting": -2.6, "gross": -1.9, "annoying": -1.9, "stupid": -2.4,
    "worthless": -2.8, "pathetic": -2.4, "guilt": -1.9, "guilty": -1.9,
    "ashamed": -2.1, "regret": -1.9, "jealous": -1.8, "unfair": -1.9,
    "worried": -1.8, "worry": -1.6, "anxious": -1.9, "nervous": -1.5,
    "despair": -2.9, "hopeless": -2.8, "miserable": -2.7, "grief": -2.6,
    "no": -1.2, "never": -1.3, "nothing": -1.2, "problem": -1.4,
    "trouble": -1.7, "danger": -2.2, "dark": -0.9, "cold": -0.7,
}

NEGATIONS = {"not", "no", "never", "neither", "nor", "cannot", "cant",
             "can't", "won't", "wont", "don't", "dont", "didn't", "didnt",
             "isn't", "isnt", "wasn't", "wasnt", "hardly", "barely",
             "without", "nobody"}

INTENSIFIERS = {"very": 0.293, "really": 0.293, "extremely": 0.293,
                "so": 0.293, "absolutely": 0.293, "completely": 0.293,
                "totally": 0.293, "incredibly": 0.293, "quite": 0.18,
                "somewhat": -0.15, "slightly": -0.293, "barely": -0.293,
                "a": 0.0}

_WORD_RE = re.compile(r"[a-z']+")


def polarity_scores(text: str) -> Dict[str, float]:
    """VADER-contract sentiment scores for a text span."""
    words = _WORD_RE.findall(text.lower())
    if not words:
        return {"pos": 0.0, "neg": 0.0, "neu": 1.0, "compound": 0.0}

    valences = []
    for i, w in enumerate(words):
        v = LEXICON.get(w, 0.0)
        if v == 0.0:
            valences.append(0.0)
            continue
        # intensifier boost from up to 2 preceding words
        boost = 0.0
        for j in (1, 2):
            if i - j >= 0 and words[i - j] in INTENSIFIERS:
                boost += INTENSIFIERS[words[i - j]] * (0.95 ** (j - 1))
        v = v + math.copysign(boost, v)
        # negation flip within 3-word window
        negated = any(words[i - j] in NEGATIONS
                      for j in (1, 2, 3) if i - j >= 0)
        if negated:
            v = -0.74 * v
        valences.append(v)

    # exclamation emphasis (cap 4)
    excl = min(text.count("!"), 4) * 0.292
    total = sum(valences)
    total = total + math.copysign(excl, total) if total else total

    compound = total / math.sqrt(total * total + 15.0)
    pos_sum = sum(v for v in valences if v > 0)
    neg_sum = -sum(v for v in valences if v < 0)
    neu_count = sum(1 for v in valences if v == 0)
    z = pos_sum + neg_sum + neu_count
    if z == 0:
        return {"pos": 0.0, "neg": 0.0, "neu": 1.0, "compound": 0.0}
    return {
        "pos": round(pos_sum / z, 3),
        "neg": round(neg_sum / z, 3),
        "neu": round(neu_count / z, 3),
        "compound": round(compound, 4),
    }


def vader_vector(text: str):
    """[pos, neg, neu, compound] — the [B, 4] vader_scores model input."""
    s = polarity_scores(text)
    return [s["pos"], s["neg"], s["neu"], s["compound"]]
