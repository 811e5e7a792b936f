"""BasePipeline: seeds, tracker, metrics, resume, the train→rollout weight
flow and the pipeline's checkpoints.

The port's own copy of socioreasoner_tpu/pipeline/base_pipeline.py. A
pipeline built with resume_from_checkpoint picks up the newest
output_dir/pipeline/checkpoint-N (the step, the metric log, re-logged to
the tracker, and the host RNG); do_checkpoint writes that state every
save_steps, and asks each of `checkpoint_clusters` for its own checkpoint
(the model and optimizer checkpoints raise in the port's strategies).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List

import numpy as np

from ..configs.rlvr_config import BaseConfig
from ..utils.metrics import MetricsManager
from ..utils.tracking import create_tracker
from ..utils.worker_state import WorkerState


class BasePipeline:
    def __init__(self, pipeline_config: BaseConfig):
        self.pipeline_config = pipeline_config
        random.seed(pipeline_config.seed)
        np.random.seed(pipeline_config.seed)
        self.tracker = create_tracker(pipeline_config.track_with,
                                      **(pipeline_config.tracker_kwargs or {}))
        self.metrics = MetricsManager()
        self.state = WorkerState()
        self.checkpoint_clusters: List = []
        self.model_update_pairs: List = []

        pipeline_dir = os.path.join(pipeline_config.output_dir, "pipeline")
        if pipeline_config.resume_from_checkpoint:
            latest = WorkerState.latest_checkpoint(pipeline_dir)
            if latest:
                self.state = WorkerState.load(latest)
                for record in self.state.log_history:
                    step = record.get("step", 0)
                    self.tracker.log({k: v for k, v in record.items() if k != "step"},
                                     step)

    def set_model_update_pair(self, src_cluster, tgt_cluster, frequency: int = 1):
        self.model_update_pairs.append((src_cluster, tgt_cluster, frequency))

    def model_update(self, step: int, snapshot: bool = False):
        """Train→rollout weight flow of the pairs due at `step`.

        Each distinct source publishes once before any target consumes (a
        second publish would hand the targets the float tree again, and each
        quantizing target would quantize it again). A target takes its own
        copy of the weights it shares with the source when `snapshot` is set
        or its pair updates less often than every step: the trainer updates
        its tensors in place, and a rollout between two updates must see the
        weights of the last one."""
        due = [(src, tgt, freq) for src, tgt, freq in self.model_update_pairs
               if step % freq == 0]
        seen = set()
        for src, _, _ in due:
            if id(src) not in seen:
                seen.add(id(src))
                src.model_update(step)
        for _, tgt, freq in due:
            tgt.model_update(step, snapshot=snapshot or freq > 1)

    def do_checkpoint(self, global_step: int):
        """Every save_steps: each checkpoint cluster's checkpoint, then the
        pipeline state under output_dir/pipeline/checkpoint-{step + 1}."""
        if self.pipeline_config.save_steps <= 0:
            return
        if (global_step + 1) % self.pipeline_config.save_steps != 0:
            return
        for cluster in self.checkpoint_clusters:
            cluster.do_checkpoint(global_step)
        self.state.step = global_step + 1
        ckpt_dir = os.path.join(self.pipeline_config.output_dir, "pipeline",
                                f"checkpoint-{global_step + 1}")
        self.state.save(ckpt_dir)

    def log_metrics(self, metrics: Dict, step: int):
        self.tracker.log(metrics, step)
        self.state.log(metrics, step)
