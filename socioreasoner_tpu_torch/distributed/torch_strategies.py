"""The decode strategy of the port: image embeddings + DecodeEngine + server.

The counterpart of the decode side of
socioreasoner_tpu/distributed/jax_strategies.py: `batch_image_embeds` runs the
ViT once per sample, and `TorchDecodeStrategy` (the JaxDecodeStrategy role)
serves generation in batch mode (`generate`) or through the request server
(`start_server` / `add_request` / `stop_server`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
from socioreasoner_tpu.protocol import BatchProto

from ..generation.engine import DecodeEngine, Request
from ..generation.sampling import SamplingParams
from ..generation.server import GenerateServer
from ..models.qwen2_5_vl.vision import run_vision, run_vision_u8


@torch.no_grad()
def batch_image_embeds(config: Qwen25VLConfig, params, batch: BatchProto,
                       prefix: str = "", image_config=None
                       ) -> List[Optional[torch.Tensor]]:
    """Per-sample merged ViT embeddings (one tower call per sample) for every
    sample in `batch`, as tensors on the parameters' device."""
    out: List[Optional[torch.Tensor]] = [None] * len(batch)
    pv_col = batch.non_tensor.get(f"{prefix}pixel_values")
    u8_col = batch.non_tensor.get(f"{prefix}pixel_u8")
    grid_col = batch.non_tensor.get(f"{prefix}grid_thw")
    for i in range(len(batch)):
        u8 = u8_col[i] if u8_col is not None else None
        pv = pv_col[i] if pv_col is not None else None
        if u8 is not None:
            if image_config is None:
                raise ValueError("pixel_u8 requires image_config")
            out[i] = run_vision_u8(config.vision, params["vision"], u8,
                                   grid_col[i], image_config)
        elif pv is not None:
            out[i] = run_vision(config.vision, params["vision"], pv, grid_col[i])
    return out


class TorchDecodeStrategy:
    """Rollout backend: continuous-batching engine + request-level server."""

    strategy_name = "torch_decode"

    def initialize(self, model_config: Qwen25VLConfig, params,
                   engine_kwargs: Optional[Dict] = None):
        self.model_config = model_config
        self.engine_kwargs = dict(engine_kwargs or {})
        self.engine = DecodeEngine(model_config, params, **self.engine_kwargs)
        self.server: Optional[GenerateServer] = None

    def model_update(self, params):
        """Swap in new weights; only while the engine is idle (in-flight
        slots hold KV computed with the old weights)."""
        if self.engine.has_work():
            raise RuntimeError(
                "model_update while the decode engine has in-flight or waiting "
                f"requests ({self.engine.num_running()} running, "
                f"{self.engine.num_waiting()} waiting); drain/stop generation "
                "before swapping weights")
        self.engine.set_params(params)

    # ------------------------------------------------------------- batch mode
    def generate(self, batch: BatchProto, generating_args) -> np.ndarray:
        """Batch generate: returns (len(batch) * n, P + max_out) rows of
        [left-padded prompt as passed in | right-padded response]."""
        sp = SamplingParams.from_generating_args(generating_args)
        n = generating_args.num_return_sequences
        pad_id = self.model_config.pad_token_id
        requests = []
        embeds = batch.meta.get("image_embeds_list")
        for i in range(len(batch)):
            ids = batch.batch["input_ids"][i]
            valid = np.asarray(batch.batch["attention_mask"][i]) == 1
            prompt_ids = np.asarray(ids)[valid].tolist()
            pos = None
            if "position_ids" in batch.batch:
                pos = np.asarray(batch.batch["position_ids"][i])[:, valid]
            for j in range(n):
                requests.append(Request(
                    request_id=(i, j), prompt_ids=prompt_ids, sampling=sp,
                    image_embeds=None if embeds is None else embeds[i],
                    position_ids=pos))
        outs = self.engine.generate(requests)
        P = np.asarray(batch.batch["input_ids"]).shape[1]
        max_out = max(len(o.output_ids) for o in outs) if outs else 0
        result = np.full((len(batch) * n, P + max_out), pad_id, np.int64)
        order = {(i, j): i * n + j for i in range(len(batch)) for j in range(n)}
        for o in outs:
            row = order[o.request_id]
            result[row, :P] = np.asarray(batch.batch["input_ids"][row // n])
            result[row, P:P + len(o.output_ids)] = o.output_ids
        return result

    # ------------------------------------------------------------ server mode
    def start_server(self, data: Optional[BatchProto] = None):
        if self.server is None:
            self.server = GenerateServer(self.engine)
        self.server.start()

    def add_request(self, command, data):
        if self.server is None:
            raise RuntimeError("start_server first")
        return self.server.add_request(command, data)

    def stop_server(self):
        if self.server is not None:
            self.server.stop()
