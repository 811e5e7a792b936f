"""LLM-as-judge reward: the port's own copy of
socioreasoner_tpu/pipeline/rlvr/rewards/llm_judge.py.

A judge model scores each response against its reference through a prompt
template. The judge is any `generate_fn(prompts) -> texts`, for example a
closure over TorchDecodeStrategy.generate in the same process.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Sequence

import numpy as np

DEFAULT_JUDGE_TEMPLATE = (
    "You are an impartial judge. Given a question, a reference answer and a "
    "candidate answer, reply with a single line 'SCORE: x' where x is 1 if the "
    "candidate is correct and 0 otherwise.\n\n"
    "Question: {question}\nReference answer: {reference}\n"
    "Candidate answer: {response}\n")

SCORE_RE = re.compile(r"SCORE:\s*([01](?:\.\d+)?)", re.IGNORECASE)


def parse_judge_score(text: str) -> float:
    """The judgment's 'SCORE: x', else 1.0 for a bare verdict starting with
    1 or saying "correct" in its first 40 characters, else 0.0."""
    m = SCORE_RE.search(text)
    if m:
        return float(m.group(1))
    t = text.strip().lower()
    if t.startswith("1") or "correct" in t[:40]:
        return 1.0
    return 0.0


def compute_llm_judge_rewards(questions: Sequence[str], responses: Sequence[str],
                              references: Sequence[str],
                              generate_fn: Callable[[List[str]], List[str]],
                              template: str = DEFAULT_JUDGE_TEMPLATE) -> Dict:
    prompts = [template.format(question=q, reference=ref, response=r)
               for q, r, ref in zip(questions, responses, references)]
    judgments = generate_fn(prompts)
    scores = np.array([parse_judge_score(j) for j in judgments], np.float32)
    return {"scores": scores, "response_level_rewards": scores,
            "metrics": {"llm_judge/mean_score": float(scores.mean())}}
