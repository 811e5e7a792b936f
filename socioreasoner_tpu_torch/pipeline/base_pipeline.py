"""BasePipeline: seeds, tracker, metrics and the in-memory metric log.

The port's own copy of socioreasoner_tpu/pipeline/base_pipeline.py without
checkpoints: `resume_from_checkpoint` raises until they are ported, and
the metric log stays in memory (`state.log_history`).
"""

from __future__ import annotations

import random
from typing import Dict

import numpy as np

from ..configs.rlvr_config import BaseConfig
from ..utils.metrics import MetricsManager
from ..utils.tracking import create_tracker
from ..utils.worker_state import WorkerState


class BasePipeline:
    def __init__(self, pipeline_config: BaseConfig):
        if pipeline_config.resume_from_checkpoint:
            raise NotImplementedError(
                "checkpoints are not ported yet (ROADMAP: the rest of the surface)")
        self.pipeline_config = pipeline_config
        random.seed(pipeline_config.seed)
        np.random.seed(pipeline_config.seed)
        self.tracker = create_tracker(pipeline_config.track_with,
                                      **(pipeline_config.tracker_kwargs or {}))
        self.metrics = MetricsManager()
        self.state = WorkerState()

    def log_metrics(self, metrics: Dict, step: int):
        self.tracker.log(metrics, step)
        self.state.log(metrics, step)
