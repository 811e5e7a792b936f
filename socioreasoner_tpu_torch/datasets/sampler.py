"""Batch index sampling with per-domain stratification: the port's own copy
of socioreasoner_tpu/datasets/sampler.py (the same numpy generator, so both
packages draw the same index sequence from a seed)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, List, Sequence

import numpy as np


class BatchStratifiedSampler:
    """Yields batches with a fixed per-domain composition.

    domain_ratios: {domain: fraction}; each batch draws round(fraction*batch_size)
    samples from that domain's pool (with reshuffle-on-exhaustion).
    """

    def __init__(self, domains: Sequence[str], domain_ratios: Dict[str, float],
                 batch_size: int, seed: int = 0, drop_last: bool = True):
        self.domains = list(domains)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.pools: Dict[str, List[int]] = defaultdict(list)
        for idx, d in enumerate(domains):
            self.pools[d].append(idx)
        total = sum(domain_ratios.values())
        self.quota = {d: max(1, round(batch_size * r / total))
                      for d, r in domain_ratios.items()}
        # fix rounding drift
        drift = batch_size - sum(self.quota.values())
        if drift != 0:
            first = next(iter(self.quota))
            self.quota[first] += drift
        self.drop_last = drop_last
        self._cursors = {d: self._shuffled(d) for d in self.pools}

    def _shuffled(self, domain: str) -> Iterator[int]:
        idxs = list(self.pools[domain])
        self.rng.shuffle(idxs)
        return iter(idxs)

    def _draw(self, domain: str) -> int:
        try:
            return next(self._cursors[domain])
        except StopIteration:
            self._cursors[domain] = self._shuffled(domain)
            return next(self._cursors[domain])

    def __iter__(self) -> Iterator[List[int]]:
        n_batches = len(self.domains) // self.batch_size
        for _ in range(max(n_batches, 1) if not self.drop_last else n_batches):
            batch: List[int] = []
            for d, q in self.quota.items():
                if d not in self.pools:
                    continue
                batch.extend(self._draw(d) for _ in range(q))
            self.rng.shuffle(batch)
            yield batch[:self.batch_size]

    def __len__(self) -> int:
        return len(self.domains) // self.batch_size
