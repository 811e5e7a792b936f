"""The one traffic generator: it reads a mix's parameters from
traffic/<mix>.json and draws its requests from the run's seed.

Every seed gets the same work with other content: the sizes (tiles a
chunk, pixels a tile) come from the mix, the seed draws the pixels, the
masks and the questions. So two seeds never differ in how much work a
window holds beyond the questions' few tokens.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

SEED_MASK = (1 << 63) - 1


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one stream of a run's seed (any whole number)."""
    return np.random.default_rng([int(seed) & SEED_MASK, *stream])


def tile_chunks(spec: Dict, seed: int) -> Iterator[List[Dict]]:
    """Endless chunks of `tiles_per_chunk` synthetic map + satellite tiles
    of `tile_px`² with a ground-truth mask and a question, drawn from the
    seed (as chip_smoke's _synthetic_tiles draws them, with the seed's own
    pixels). A chunk: [{"id", "map", "sat", "mask", "question"}] as uint8
    arrays."""
    n, px = int(spec["tiles_per_chunk"]), int(spec["tile_px"])
    questions = list(spec["questions"])
    rng = rng_for(seed, 3)
    chunk = 0
    while True:
        tiles = []
        for i in range(n):
            mask = np.zeros((px, px), np.uint8)
            y0, x0 = (int(v) for v in rng.integers(0, px // 2, 2))
            mask[y0:y0 + px // 4, x0:x0 + px // 3] = 255
            tiles.append({
                "id": f"c{chunk}t{i}",
                "map": rng.integers(0, 256, (px, px, 3), dtype=np.uint8),
                "sat": rng.integers(0, 256, (px, px, 3), dtype=np.uint8),
                "mask": mask,
                "question": questions[int(rng.integers(0, len(questions)))],
            })
        yield tiles
        chunk += 1
