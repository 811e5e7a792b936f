"""Role workers: actor, SAM2, rule rewards, reward model, SocioSeg reward.

The port's copy of socioreasoner_tpu/pipeline/base_worker.py: a pipeline
talks to a Cluster of these through their registered methods; the
strategies carry the device work and the workers the host glue (decoding
texts, parsing prompts, shaping BatchProto columns).

A yaml's `rewards:` block names a rule worker by its dotted path; each
subclass of RuleRewardWorker binds one reward function of
pipeline/rlvr/rewards/ over the response_text and ground_truth columns.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ..generation.server import GenerateRequestType
from ..protocol import BatchProto
from ..runtime.dispatch import Dispatch, register
from ..runtime.worker import Worker
from .rlvr.parsing import parse_visual_prompts_s1, parse_visual_prompts_s2
from .rlvr.rewards.code_sandbox import compute_code_rewards
from .rlvr.rewards.general_rules import compute_crossthink_rewards, compute_general_val_scores
from .rlvr.rewards.math_rule import compute_math_rewards
from .rlvr.rewards.socioseg import compute_socioseg_rewards


def _reward_proto(out: Dict) -> BatchProto:
    """A reward function's result as a BatchProto: its arrays and lists as
    tensors, everything else (the metrics) as meta."""
    tensors = {k: np.asarray(v) for k, v in out.items() if isinstance(v, (np.ndarray, list))}
    meta = {k: v for k, v in out.items() if k not in tensors}
    return BatchProto.from_dict(tensors=tensors, meta=meta)


class ActorWorker(Worker):
    """Hosts a torch_train, torch_infer or torch_decode strategy."""

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def initialize(self, pipeline_config=None, strategy=None):
        super().initialize(pipeline_config)
        self.strategy = strategy

    @register(dispatch_mode=Dispatch.DP_MP_COMPUTE)
    def train_step(self, data: BatchProto) -> BatchProto:
        """strategy.train_step over mini-batches of backward_batch_size rows
        (all rows when unset) for the config's ppo_epochs; the mean of each
        metric in meta["metrics"]."""
        metrics: Dict[str, List[float]] = {}
        bbs = self.worker_config.backward_batch_size
        ppo_epochs = getattr(self.pipeline_config, "ppo_epochs", 1) if self.pipeline_config else 1
        if bbs is None or bbs <= 0:
            bbs = len(data)
        for mini in data.make_iterator(bbs, epochs=ppo_epochs):
            for k, v in self.strategy.train_step(mini).items():
                metrics.setdefault(k, []).append(v)
        return BatchProto(meta={"metrics": {k: float(np.mean(v)) for k, v in metrics.items()}})

    @register(dispatch_mode=Dispatch.DP_MP_COMPUTE)
    def compute_log_probs(self, data: BatchProto) -> BatchProto:
        out = self.strategy.compute_log_probs(data)
        return BatchProto.from_dict(tensors={"log_probs": out["log_probs"],
                                             "entropy": out["entropy"]})

    @register(dispatch_mode=Dispatch.DP_MP_COMPUTE)
    def generate(self, data: BatchProto, generating_args=None) -> BatchProto:
        """Batch rollout: the full right-padded sequences under "output"."""
        gen_args = generating_args or self.worker_config.generating_args
        return BatchProto.from_dict(tensors={"output": self.strategy.generate(data, gen_args)})

    # -------------------------------------------------- request-level serving
    @register(dispatch_mode=Dispatch.ONE_TO_ALL_ONE)
    def start_server(self, data: Optional[BatchProto] = None):
        self.strategy.start_server(data)

    @register(dispatch_mode=Dispatch.ONE_TO_ALL_ONE)
    def stop_server(self):
        self.strategy.stop_server()

    @register(dispatch_mode=Dispatch.ONE_TO_ALL_ONE, blocking=True)
    def add_request(self, command: GenerateRequestType, data: Optional[Dict] = None):
        return self.strategy.add_request(command, data)

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def model_update(self, step: int = 0):
        self.strategy.model_update()

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def do_checkpoint(self, global_step: int):
        if hasattr(self.strategy, "save_checkpoint"):
            self.strategy.save_checkpoint(global_step)


class SegWorker(Worker):
    """SAM2 mask decoding over a SegStrategy."""

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def initialize(self, pipeline_config=None, strategy=None):
        super().initialize(pipeline_config)
        self.strategy = strategy

    def _segment(self, data: BatchProto, response_key: str, parser: Callable) -> BatchProto:
        prompts_col = []
        for text in data.non_tensor[response_key]:
            vp = []
            for obj in parser(str(text)):
                entry = {}
                if "box" in obj:
                    entry["box"] = obj["box"]
                if obj.get("points"):
                    entry["points"] = obj["points"]
                    entry["labels"] = obj.get("labels", [1] * len(obj["points"]))
                vp.append(entry)
            prompts_col.append(vp)
        seg_batch = BatchProto.from_dict(non_tensors={
            "seg_image": list(data.non_tensor["seg_image"]), "visual_prompt": prompts_col})
        results = self.strategy.segment(seg_batch)
        return BatchProto.from_dict(non_tensors={
            "mask": [r["mask"] for r in results], "visual_prompt": prompts_col})

    @register(dispatch_mode=Dispatch.DP_MP_COMPUTE)
    def segment_v4_map(self, data: BatchProto) -> BatchProto:
        """Stage 1: box prompts parsed from the map responses."""
        return self._segment(data, "map_response_text", parse_visual_prompts_s1)

    @register(dispatch_mode=Dispatch.DP_MP_COMPUTE)
    def segment_v4_sat(self, data: BatchProto) -> BatchProto:
        """Stage 2: box and point prompts parsed from the sat responses."""
        return self._segment(data, "response_text", parse_visual_prompts_s2)


class RuleRewardWorker(Worker):
    """A text rule reward over the response_text and ground_truth columns;
    each subclass binds its `reward_fn(texts, ground_truths) -> dict`."""

    reward_fn = None

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def initialize(self, pipeline_config=None, tokenizer=None):
        super().initialize(pipeline_config)
        self.tokenizer = tokenizer

    @register(dispatch_mode=Dispatch.DP_MP_COMPUTE)
    def compute_rewards(self, data: BatchProto) -> BatchProto:
        texts = [str(t) for t in data.non_tensor["response_text"]]
        return _reward_proto(type(self).reward_fn(texts, list(data.non_tensor["ground_truth"])))


class MathRuleRewardWorker(RuleRewardWorker):
    reward_fn = staticmethod(compute_math_rewards)


class CodeSandboxRewardWorker(RuleRewardWorker):
    """Generated code against its test cases: on the remote sandbox service
    when the worker config has a `code_url`, else in a local rlimited
    subprocess."""

    reward_fn = staticmethod(compute_code_rewards)

    @register(dispatch_mode=Dispatch.DP_MP_COMPUTE)
    def compute_rewards(self, data: BatchProto) -> BatchProto:
        url = getattr(self.worker_config, "code_url", None)
        if url:
            texts = [str(t) for t in data.non_tensor["response_text"]]
            return _reward_proto(compute_code_rewards(
                texts, list(data.non_tensor["ground_truth"]), code_url=url))
        return RuleRewardWorker.compute_rewards(self, data)


class CrossThinkQARewardWorker(RuleRewardWorker):
    reward_fn = staticmethod(compute_crossthink_rewards)


class GeneralValRuleRewardWorker(RuleRewardWorker):
    """Validation accuracy across domains. Every row it gets is of the
    domain its cluster is named for (the pipeline routes rows by tag); the
    JAX worker calls compute_general_val_scores without the domains, which
    that function requires, and raises."""

    reward_fn = staticmethod(compute_general_val_scores)

    @register(dispatch_mode=Dispatch.DP_MP_COMPUTE)
    def compute_rewards(self, data: BatchProto) -> BatchProto:
        texts = [str(t) for t in data.non_tensor["response_text"]]
        return _reward_proto(compute_general_val_scores(
            texts, list(data.non_tensor["ground_truth"]), [self.cluster_name] * len(texts)))


class RewardWorker(Worker):
    """A model reward: the scalar value head of a TorchRewardStrategy read
    at each sequence's last token."""

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def initialize(self, pipeline_config=None, strategy=None, tokenizer=None):
        super().initialize(pipeline_config)
        self.strategy = strategy
        self.tokenizer = tokenizer

    @register(dispatch_mode=Dispatch.DP_MP_COMPUTE)
    def compute_rewards(self, data: BatchProto) -> BatchProto:
        """token_level_rewards (B, L-1), the values in the shifted frame, and
        response_level_rewards (B,), the value at the last non-pad position:
        argmax(is_pad) - 1 modulo L-1, so a row without pad wraps to its
        last position."""
        token_level = np.asarray(self.strategy.compute_values(data))
        input_ids = np.asarray(data.batch["input_ids"])[:, 1:]
        is_pad = (input_ids == data.meta.get("pad_token_id", 0)).astype(np.int64)
        seq_lengths = (np.argmax(is_pad, axis=-1) - 1) % input_ids.shape[-1]
        response_level = token_level[np.arange(len(token_level)), seq_lengths]
        return BatchProto.from_dict(tensors={"token_level_rewards": token_level,
                                             "response_level_rewards": response_level})


class SocioSegRuleRewardWorker(Worker):
    """The SocioSeg rule reward of two-stage rollouts, on the CPU."""

    @register(dispatch_mode=Dispatch.ONE_TO_ALL)
    def initialize(self, pipeline_config=None, tokenizer=None):
        super().initialize(pipeline_config)
        self.tokenizer = tokenizer

    @register(dispatch_mode=Dispatch.DP_MP_COMPUTE)
    def compute_rewards_split(self, data: BatchProto) -> BatchProto:
        """Per-sample reward arrays of `data` (non-tensors map_response_text,
        sat_response_text, map_mask, sat_mask, gt_mask, gt_bbox, bboxs_text):
        the response-level rewards, seg_iou and each component under
        components/, with their means in meta["metrics"]."""
        gt_masks = [np.asarray(m.convert("L")) if hasattr(m, "convert") else np.asarray(m)
                    for m in data.non_tensor["gt_mask"]]
        out = compute_socioseg_rewards(
            map_responses=[str(t) for t in data.non_tensor["map_response_text"]],
            sat_responses=[str(t) for t in data.non_tensor["sat_response_text"]],
            map_masks=list(data.non_tensor["map_mask"]),
            sat_masks=list(data.non_tensor["sat_mask"]),
            gt_masks=gt_masks,
            gt_bbox_texts=[str(t) for t in data.non_tensor["gt_bbox"]],
            stage1_bbox_texts=[str(t) for t in data.non_tensor["bboxs_text"]],
        )
        # the component arrays ride along, so that a cluster's collect (the
        # concatenation) lets the caller take the means over the full batch
        tensors = {k: v for k, v in out.items() if isinstance(v, np.ndarray)}
        return BatchProto.from_dict(tensors=tensors, meta={"metrics": out["metrics"]})
