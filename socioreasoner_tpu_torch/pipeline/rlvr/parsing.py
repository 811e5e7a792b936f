"""Response parsing: model text → visual prompts (bboxes / points).

The port's own copy of socioreasoner_tpu/pipeline/rlvr/parsing.py, kept as it
is there (behaviour parity with the reference's seg-worker parsers):
  parse_visual_prompts_s1 — stage-1 answers: [{"bbox_2d":[x1,y1,x2,y2]}, ...]
                            → [{"box": [...]}, ...]
  parse_visual_prompts_s2 — stage-2 answers: bbox + "points" [[x,y],...] →
                            box/points/labels (all 1s)
  parse_answer_text       — the text between the answer tags
Malformed JSON / objects are skipped silently (the reward handles punishment).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional

ANSWER_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)
THINK_ANSWER_RE = re.compile(r"<think>.*?</think>\s*<answer>.*?</answer>", re.DOTALL)

SPECIAL_TOKENS = ("<|endoftext|>", "<|im_end|>", "<pad>")


def strip_special_tokens(text: str) -> str:
    for tok in SPECIAL_TOKENS:
        text = text.replace(tok, "")
    return text


def parse_answer_text(content: str) -> Optional[str]:
    m = ANSWER_RE.search(content)
    return m.group(1).strip() if m else None


def _parse_answer_json(content: str) -> Optional[list]:
    text = parse_answer_text(content)
    if text is None:
        return None
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        return None
    return data if isinstance(data, list) else None


def parse_visual_prompts_s1(content: str) -> List[Dict[str, Any]]:
    """Stage-1: bbox-only prompts for the mask decoder."""
    data = _parse_answer_json(content)
    out = []
    for obj in data or []:
        if not isinstance(obj, dict):
            continue
        box = obj.get("bbox_2d", [])
        if isinstance(box, list) and len(box) == 4:
            out.append({"box": box})
    return out


def parse_visual_prompts_s2(content: str) -> List[Dict[str, Any]]:
    """Stage-2: bbox + positive point prompts (labels all 1)."""
    data = _parse_answer_json(content)
    out = []
    for obj in data or []:
        if not isinstance(obj, dict):
            continue
        box = obj.get("bbox_2d", [])
        try:
            points = [[p[0], p[1]] for p in obj.get("points", [])]
        except (TypeError, IndexError):
            continue
        if isinstance(box, list) and len(box) == 4:
            out.append({"box": box, "points": points, "labels": [1] * len(points)})
    return out


def parse_bboxes(content: str) -> List[List[float]]:
    """Bare bbox list from an answer (used when re-prompting stage 2)."""
    return [p["box"] for p in parse_visual_prompts_s1(content)]


def has_think_answer_format(content: str) -> bool:
    return THINK_ANSWER_RE.fullmatch(content.strip()) is not None
