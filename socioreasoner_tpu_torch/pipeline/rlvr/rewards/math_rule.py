"""Math rule reward: the port's own copy of
socioreasoner_tpu/pipeline/rlvr/rewards/math_rule.py.

Extract the final answer (\\boxed{...}, <answer> tags, or the last number),
normalise LaTeX-ish notation, compare exactly as fractions (percentages
included) or within 1e-6 relative as floats. The format reward checks the
think/answer structure or a boxed answer.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Optional, Sequence

import numpy as np

from ..parsing import ANSWER_RE, THINK_ANSWER_RE

BOXED_RE = re.compile(r"\\boxed\s*\{([^{}]*(?:\{[^{}]*\}[^{}]*)*)\}")
NUMBER_RE = re.compile(r"-?\d+(?:\.\d+)?(?:e-?\d+)?")


def extract_answer(text: str) -> Optional[str]:
    m = BOXED_RE.findall(text)
    if m:
        return m[-1].strip()
    m2 = ANSWER_RE.search(text)
    if m2:
        inner = m2.group(1).strip()
        b = BOXED_RE.findall(inner)
        return (b[-1] if b else inner).strip()
    nums = NUMBER_RE.findall(text)
    return nums[-1] if nums else None


def _normalize(ans: str) -> str:
    ans = ans.strip().strip("$").strip()
    ans = ans.replace("\\left", "").replace("\\right", "")
    ans = ans.replace("\\,", "").replace("\\!", "").replace(" ", "")
    ans = ans.replace("dfrac", "frac").replace("tfrac", "frac")
    ans = re.sub(r"\\text\{[^}]*\}", "", ans)
    return ans.rstrip(".")


def _ratio(num: str, den: str) -> Optional[Fraction]:
    try:
        return Fraction(int(num), int(den))
    except ZeroDivisionError:
        return None


def _to_number(ans: str) -> Optional[Fraction]:
    ans = _normalize(ans)
    m = (re.fullmatch(r"\\frac\{(-?\d+)\}\{(-?\d+)\}", ans)
         or re.fullmatch(r"(-?\d+)/(-?\d+)", ans))
    if m:
        return _ratio(m.group(1), m.group(2))
    if ans.endswith("%"):
        try:
            return Fraction(ans[:-1]) / 100
        except ValueError:
            return None
    try:
        return Fraction(ans)
    except ValueError:
        pass
    try:
        return Fraction(str(float(ans)))
    except (ValueError, OverflowError):
        return None


def answers_match(pred: str, gt: str) -> bool:
    if _normalize(pred) == _normalize(gt):
        return True
    fp, fg = _to_number(pred), _to_number(gt)
    if fp is None or fg is None:
        return False
    return fp == fg or abs(float(fp) - float(fg)) <= 1e-6 * max(1.0, abs(float(fg)))


def math_format_reward(text: str) -> float:
    return 1.0 if (THINK_ANSWER_RE.fullmatch(text.strip())
                   or BOXED_RE.search(text)) else 0.0


def math_accuracy_reward(text: str, ground_truth: str) -> float:
    pred = extract_answer(text)
    if pred is None:
        return 0.0
    gt = extract_answer(ground_truth) or ground_truth
    return 1.0 if answers_match(pred, gt) else 0.0


def compute_math_rewards(responses: Sequence[str], ground_truths: Sequence[str],
                         format_weight: float = 0.1):
    """scores (accuracy), response_level_rewards (accuracy + format_weight x
    format), and the batch's math/accuracy and math/format means."""
    acc = np.array([math_accuracy_reward(r, g)
                    for r, g in zip(responses, ground_truths)], np.float32)
    fmt = np.array([math_format_reward(r) for r in responses], np.float32)
    return {"scores": acc,
            "response_level_rewards": acc + format_weight * fmt,
            "metrics": {"math/accuracy": float(acc.mean()),
                        "math/format": float(fmt.mean())}}
