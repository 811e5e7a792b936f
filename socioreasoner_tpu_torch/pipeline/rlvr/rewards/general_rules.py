"""General QA rule rewards: the port's own copy of
socioreasoner_tpu/pipeline/rlvr/rewards/general_rules.py.

CrossThink-QA scoring (a multiple-choice letter, else a normalised text
match, else a numeric match), its think/answer format reward, and the
validation dispatcher that scores math with the math rule and everything
else with CrossThink matching.
"""

from __future__ import annotations

import re
import string
from typing import Dict, Optional, Sequence

import numpy as np

from ..parsing import ANSWER_RE, THINK_ANSWER_RE
from .math_rule import answers_match, extract_answer, math_accuracy_reward

MCQ_RE = re.compile(r"\b([A-E])\b")


def normalize_text(text: str) -> str:
    text = text.lower().strip()
    text = text.translate(str.maketrans("", "", string.punctuation))
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    return " ".join(text.split())


def extract_choice(text: str) -> Optional[str]:
    """The answer's last multiple-choice letter (A-E)."""
    m = ANSWER_RE.search(text)
    scope = m.group(1) if m else text
    letters = MCQ_RE.findall(scope.upper())
    return letters[-1] if letters else None


def crossthink_accuracy(response: str, ground_truth: str) -> float:
    """1.0 when the response answers `ground_truth`: the letter when the
    ground truth is a letter, else the normalised text (equal or contained),
    else the number."""
    gt = ground_truth.strip()
    if len(gt) == 1 and gt.upper() in "ABCDE":
        return 1.0 if extract_choice(response) == gt.upper() else 0.0
    m = ANSWER_RE.search(response)
    pred = (m.group(1) if m else response).strip()
    if normalize_text(pred) == normalize_text(gt):
        return 1.0
    if normalize_text(gt) and normalize_text(gt) in normalize_text(pred):
        return 1.0
    pa, ga = extract_answer(response), extract_answer(gt) or gt
    if pa is not None and answers_match(pa, ga):
        return 1.0
    return 0.0


def crossthink_format(response: str) -> float:
    return 1.0 if THINK_ANSWER_RE.fullmatch(response.strip()) else 0.0


def compute_crossthink_rewards(responses: Sequence[str], ground_truths: Sequence[str],
                               format_weight: float = 0.1) -> Dict:
    acc = np.array([crossthink_accuracy(r, g) for r, g in zip(responses, ground_truths)],
                   np.float32)
    fmt = np.array([crossthink_format(r) for r in responses], np.float32)
    return {"scores": acc,
            "response_level_rewards": acc + format_weight * fmt,
            "metrics": {"crossthinkqa/accuracy": float(acc.mean()),
                        "crossthinkqa/format": float(fmt.mean())}}


def compute_general_val_scores(responses: Sequence[str], ground_truths: Sequence[str],
                               domains: Sequence[str]) -> Dict:
    """Validation accuracy: a domain naming math → the math rule; any other
    → CrossThink matching; the accuracy per domain and over all."""
    scores = np.zeros(len(responses), np.float32)
    per_domain: Dict[str, list] = {}
    for i, (r, g, d) in enumerate(zip(responses, ground_truths, domains)):
        if d and "math" in d:
            scores[i] = math_accuracy_reward(r, g)
        else:
            scores[i] = crossthink_accuracy(r, g)
        per_domain.setdefault(d or "default", []).append(scores[i])
    metrics = {f"val/{d}/accuracy": float(np.mean(v)) for d, v in per_domain.items()}
    metrics["val/accuracy"] = float(scores.mean())
    return {"scores": scores, "response_level_rewards": scores, "metrics": metrics}
