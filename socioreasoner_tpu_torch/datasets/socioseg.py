"""SocioSeg sample encoding and prompt formats, for the port.

The port's own copy of the host half of socioreasoner_tpu/datasets/socioseg.py
that the two-stage pipeline and training need (the port imports nothing of
the JAX package):
  format_stage1_prompt / format_stage2_prompt — the prompt templates
  count_components / extract_gt_bboxes        — GT mask components and boxes
  encode_sample                               — one raw tile → pipeline columns
  load_socioseg_dir                           — the on-disk tile layout
  render_visual_prompt                        — the stage-2 restage render

The JAX package counts components with its native host library
(csrc/socio_host.cpp, union-find); here scipy.ndimage.label with 8-connectivity
gives the same components, numbered in the same raster order of their first
pixel. The HF-hub dataset loading stays in the JAX package until the
loaders are ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Sequence, Union

import numpy as np
from PIL import Image, ImageDraw

from .processor import ImageProcessorConfig, build_chat_text, resize_image

STAGE1_TEMPLATE = (
    "You will be given two images. The first is a map and the second is a corresponding satellite image."
    "Please find '{prompt}' with bboxs."
    "Compare the difference between object(s) and find the most closely matched object(s)."
    "Output the thinking process in <think> </think> and final answer in <answer> </answer> tags. Please use English."
    "Output the bbox(es) in JSON format."
    "i.e., <think>thinking process here </think>"
    "<answer>{answer}</answer>"
)
STAGE1_ANSWER = '[{"bbox_2d": [bx1,by1,bx2,by2]}, {"bbox_2d": [bx3,by3,bx4,by4]}]'

STAGE2_TEMPLATE = (
    "You will be given two images. The first is a map and the second is a corresponding satellite image."
    'Now some bbox(s) and the results after SAM segmentation for "{prompt}" have been rendered on these two images.'
    "The found bbox(s) are: {bboxs}."
    "Please add some points appropriately to each bbox to better represent the area of interest."
    "Output the thinking process in <think> </think> and final answer in <answer> </answer> tags."
    "i.e., <think> thinking process here </think>"
    "<answer>{answer}</answer>"
)
STAGE2_ANSWER = ('[{"bbox_2d": [bx1,by1,bx2,by2], "points": [[px1,py1],[px2,py2],[px3,py3]]}, '
                 '{"bbox_2d": [bx3,by3,bx4,by4], "points": [[px4,py4],[px5,py5],[px6,py6]}]')


def format_stage1_prompt(prompt: str, n_images: int = 2) -> str:
    return build_chat_text(STAGE1_TEMPLATE.format(prompt=prompt, answer=STAGE1_ANSWER),
                           n_images)


def format_stage2_prompt(prompt: str, bboxs_text: str, n_images: int = 2) -> str:
    return build_chat_text(
        STAGE2_TEMPLATE.format(prompt=prompt, bboxs=bboxs_text, answer=STAGE2_ANSWER),
        n_images)


# ------------------------------------------------------------- GT extraction

def _components(mask: np.ndarray):
    """8-connected components of mask > 0: (labels, count), numbered 1.. in
    the raster order of each component's first pixel."""
    from scipy import ndimage
    return ndimage.label(np.asarray(mask) > 0, structure=np.ones((3, 3), np.int32))


def count_components(mask_image: Image.Image) -> int:
    """8-connected component count of the binary GT mask."""
    return int(_components(np.asarray(mask_image.convert("L")))[1])


def component_boxes(mask: np.ndarray, min_area: int = 10) -> List[List[int]]:
    """[x1, y1, x2, y2] (x2, y2 exclusive) per component with pixel area >
    min_area, in component order."""
    labels, n = _components(mask)
    if n == 0:
        return []
    area = np.bincount(labels.ravel(), minlength=n + 1)
    from scipy import ndimage
    return [[sl[1].start, sl[0].start, sl[1].stop, sl[0].stop]
            for lab, sl in enumerate(ndimage.find_objects(labels), start=1)
            if area[lab] > min_area]


def extract_gt_bboxes(mask_image: Image.Image, min_area: float = 10) -> str:
    """Component bounding boxes → bbox JSON string."""
    arr = np.asarray(mask_image.convert("L"))
    return json.dumps([{"bbox_2d": b} for b in component_boxes(arr, min_area=int(min_area))])


# ----------------------------------------------------------------- encoding

def encode_sample(sample: Dict[str, Any], image_config: ImageProcessorConfig
                  ) -> Dict[str, Any]:
    """One raw tile → the columns the pipeline consumes: resized map/sat
    images, stage-1 prompt text, GT mask/bboxes/count, raw sat for
    segmentation."""
    def load(img) -> Image.Image:
        if isinstance(img, Image.Image):
            return img
        if isinstance(img, (str, os.PathLike)):
            return Image.open(img).convert("RGB")
        return Image.fromarray(np.asarray(img))

    map_img = load(sample["map"])
    sat_img = load(sample["sat"])
    mask_img = load(sample["mask"])
    prompt = sample.get("question", sample.get("prompt", ""))
    if isinstance(prompt, dict):
        prompt = prompt.get("question", "")

    map_resized = resize_image(map_img, image_config)
    sat_resized = resize_image(sat_img, image_config)

    return {
        "id": sample.get("id", ""),
        "question": prompt,
        "prompt_map": format_stage1_prompt(prompt),
        "gt_mask": mask_img,
        "gt_bbox": extract_gt_bboxes(mask_img),
        "gt_object": count_components(mask_img),
        "image_map": map_resized,
        "image_sat": sat_resized,
        "seg_image": sat_img,           # raw satellite, mask-decoder input
        "image": [map_resized, sat_resized],
        "tag": sample.get("tag", ""),
    }


def load_socioseg_dir(root: str, split: str = "train") -> List[Dict[str, Any]]:
    """Directory layout: root/split/<id>/{map.png,sat.png,mask.png,question.json}."""
    split_dir = os.path.join(root, split)
    samples = []
    if not os.path.isdir(split_dir):
        return samples
    for tile_id in sorted(os.listdir(split_dir)):
        d = os.path.join(split_dir, tile_id)
        if not os.path.isdir(d):
            continue
        q = {}
        qpath = os.path.join(d, "question.json")
        if os.path.exists(qpath):
            with open(qpath) as f:
                q = json.load(f)
        samples.append({
            "id": tile_id,
            "map": os.path.join(d, "map.png"),
            "sat": os.path.join(d, "sat.png"),
            "mask": os.path.join(d, "mask.png"),
            "question": q.get("question", q) if isinstance(q, dict) else q,
        })
    return samples


# ------------------------------------------------------------------ rendering

def render_visual_prompt(bboxes_json: str, images: Sequence[Image.Image],
                         mask: Union[np.ndarray, Image.Image]) -> List[Image.Image]:
    """Draw stage-1 bboxes (blue, width 2) + 40%-alpha red mask overlay onto the
    map/sat pair for the stage-2 prompt (ref render_image :378-449)."""
    overlay = None
    try:
        mask_arr = np.asarray(mask.convert("L") if isinstance(mask, Image.Image) else mask)
        if images:
            w0, h0 = images[0].size
            m = np.asarray(Image.fromarray(mask_arr.astype(np.uint8)).resize(
                (w0, h0), Image.Resampling.NEAREST)) > 0
            rgba = np.zeros((h0, w0, 4), np.uint8)
            rgba[m] = [255, 0, 0, int(255 * 0.4)]
            overlay = Image.fromarray(rgba, "RGBA")
    except Exception:
        overlay = None

    boxes: List[List[float]] = []
    try:
        data = json.loads(bboxes_json)
        if isinstance(data, list):
            boxes = [it["bbox_2d"] for it in data
                     if isinstance(it, dict) and len(it.get("bbox_2d", [])) == 4]
    except (json.JSONDecodeError, TypeError):
        boxes = []

    out = []
    for image in images:
        img = image.copy().convert("RGBA")
        if boxes:
            draw = ImageDraw.Draw(img)
            for b in boxes:
                try:
                    draw.rectangle([(b[0], b[1]), (b[2], b[3])], outline="blue", width=2)
                except Exception:
                    continue
        if overlay is not None:
            ov = overlay if overlay.size == img.size else overlay.resize(
                img.size, Image.Resampling.LANCZOS)
            img = Image.alpha_composite(img, ov)
        out.append(img.convert("RGB"))
    return out
