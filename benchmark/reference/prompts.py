"""The plain reference of SocioSeg's prompts as a tokenized sequence: the
Qwen chat template, the two stage templates of the published SocioReasoner
project, a byte-level tokenizer with Qwen's special tokens (the stand-in
for the real tokenizer that deployments without its files use: each UTF-8
byte b is id b + 3), each image's placeholder expanded to one token a 2 x 2
block of patches, and Qwen2.5-VL's M-RoPE positions (HF `get_rope_index`):
text runs on all three axes alike, an image block on (t, row, column) of
its merged grid, text after it continuing from the block's largest
position plus one.

Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

SPECIAL = {"<|im_start|>": 151644, "<|im_end|>": 151645, "<|vision_start|>": 151652,
           "<|vision_end|>": 151653, "<|image_pad|>": 151655, "<|video_pad|>": 151656,
           "<|endoftext|>": 151643}
IMAGE_TOKEN = SPECIAL["<|image_pad|>"]

STAGE1 = (
    "You will be given two images. The first is a map and the second is a corresponding satellite image."
    "Please find '{prompt}' with bboxs."
    "Compare the difference between object(s) and find the most closely matched object(s)."
    "Output the thinking process in <think> </think> and final answer in <answer> </answer> tags. Please use English."
    "Output the bbox(es) in JSON format."
    "i.e., <think>thinking process here </think>"
    "<answer>{answer}</answer>")
STAGE1_ANSWER = '[{"bbox_2d": [bx1,by1,bx2,by2]}, {"bbox_2d": [bx3,by3,bx4,by4]}]'
STAGE2 = (
    "You will be given two images. The first is a map and the second is a corresponding satellite image."
    'Now some bbox(s) and the results after SAM segmentation for "{prompt}" have been rendered on these two images.'
    "The found bbox(s) are: {bboxs}."
    "Please add some points appropriately to each bbox to better represent the area of interest."
    "Output the thinking process in <think> </think> and final answer in <answer> </answer> tags."
    "i.e., <think> thinking process here </think>"
    "<answer>{answer}</answer>")
STAGE2_ANSWER = ('[{"bbox_2d": [bx1,by1,bx2,by2], "points": [[px1,py1],[px2,py2],[px3,py3]]}, '
                 '{"bbox_2d": [bx3,by3,bx4,by4], "points": [[px4,py4],[px5,py5],[px6,py6]}]')


def chat(user_text: str, n_images: int) -> str:
    image = "<|vision_start|><|image_pad|><|vision_end|>" * n_images
    return ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
            f"<|im_start|>user\n{image}{user_text}<|im_end|>\n<|im_start|>assistant\n")


def stage1_text(question: str) -> str:
    return chat(STAGE1.format(prompt=question, answer=STAGE1_ANSWER), 2)


def stage2_text(question: str, boxes_json: str) -> str:
    return chat(STAGE2.format(prompt=question, bboxs=boxes_json, answer=STAGE2_ANSWER), 2)


def tokenize(text: str) -> List[int]:
    ids: List[int] = []
    i = 0
    while i < len(text):
        for tok, tid in SPECIAL.items():
            if text.startswith(tok, i):
                ids.append(tid)
                i += len(tok)
                break
        else:
            ids.extend(b + 3 for b in text[i].encode("utf-8"))
            i += 1
    return ids


def text_of(ids: Sequence[int]) -> str:
    """The bytes among ids (ids 3..258), as text; other ids dropped."""
    return bytes(int(t) - 3 for t in ids if 3 <= int(t) < 259).decode("utf-8", "replace")


def expand_images(ids: List[int], grids: Sequence[Tuple[int, int, int]], merge: int = 2):
    out, k = [], 0
    for t in ids:
        if t == IMAGE_TOKEN:
            gt, gh, gw = grids[k]
            out.extend([IMAGE_TOKEN] * (gt * gh * gw // merge ** 2))
            k += 1
        else:
            out.append(t)
    return out


def mrope_positions(ids: Sequence[int], grids, merge: int = 2) -> np.ndarray:
    """(3, T) positions of one unpadded sequence."""
    ids = np.asarray(ids)
    T = len(ids)
    pos = np.zeros((3, T), np.int64)
    i, nxt, k = 0, 0, 0
    while i < T:
        if ids[i] == IMAGE_TOKEN:
            gt, gh, gw = grids[k]
            h, w = gh // merge, gw // merge
            n = gt * h * w
            tt = np.repeat(np.arange(gt), h * w)
            hh = np.tile(np.repeat(np.arange(h), w), gt)
            ww = np.tile(np.arange(w), gt * h)
            pos[:, i:i + n] = np.stack([tt, hh, ww]) + nxt
            nxt = int(pos[:, i:i + n].max()) + 1
            i += n
            k += 1
        else:
            pos[:, i] = nxt
            nxt += 1
            i += 1
    return pos
