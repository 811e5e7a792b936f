"""Pipeline construction: SocioSegConfig + checkpoints → runnable pipelines.

The port's counterpart of socioreasoner_tpu/pipeline/rlvr/build.py, the
from-config path the entry scripts take (the reference's
`SocioSegPipeline.__init__` cluster construction,
rlvr_socioseg_vlm_pipeline.py:452-613): the Qwen2.5-VL policy and SAM2
from the local HF checkpoint directories the yaml names (random weights at
the flagship architectures when a path is not a directory), the processor
from the tokenizer files beside the policy checkpoint, the SocioSeg split
from dataset_dir, and the engine settings. Tensors go to the GPU unless a
device is named.
"""

from __future__ import annotations

import os
from typing import Dict, List

import torch

from ...configs.rlvr_config import SocioSegConfig
from ...configs.validation import validate_config
from ...datasets.processor import (ImageProcessorConfig, SimpleTokenizer,
                                   SocioProcessor, load_hf_tokenizer)
from ...datasets.socioseg import encode_sample, load_socioseg_dir
from ...models.qwen2_5_vl import loader as qloader
from ...models.qwen2_5_vl import model as qmodel
from ...models.qwen2_5_vl.config import Qwen25VLConfig
from ...models.qwen2_5_vl.convert import param_device
from ...models.sam2 import loader as sloader
from ...models.sam2 import model as smodel
from ...models.sam2.config import Sam2Config


def build_processor(cfg: SocioSegConfig, model_config: Qwen25VLConfig) -> SocioProcessor:
    """The HF tokenizer of a `pretrain` directory, else SimpleTokenizer;
    the image processor from actor_train.model_args' pixel bounds."""
    ma = cfg.actor_train.model_args
    img_cfg = ImageProcessorConfig(
        min_pixels=ma.pixels("min_pixels") or 56 * 56,
        max_pixels=ma.pixels("max_pixels") or 28 * 28 * 1280,
        # uint8 upload + on-device patchify (vision.patchify_device)
        defer_patchify=True)
    pretrain = cfg.pretrain
    if pretrain and os.path.isdir(pretrain):
        tokenizer = load_hf_tokenizer(pretrain)
    else:
        tokenizer = SimpleTokenizer()
    return SocioProcessor(tokenizer, img_cfg, image_token_id=model_config.image_token_id)


def load_policy(cfg: SocioSegConfig, dtype=torch.bfloat16, device=None):
    """(config, tree) of the `pretrain` checkpoint directory. Without one, a
    random init of Qwen25VLConfig() from a torch.Generator seeded with
    cfg.seed: the same architecture as the JAX package's
    jax.random.key(cfg.seed) init, but other values."""
    pretrain = cfg.pretrain
    if pretrain and os.path.isdir(pretrain):
        return qloader.load_pretrained(pretrain, dtype=dtype, device=device)
    device = param_device(device)
    model_config = Qwen25VLConfig()
    params = qmodel.init_params(model_config,
                                torch.Generator(device=device).manual_seed(cfg.seed),
                                dtype=dtype, device=device)
    return model_config, params


def load_sam(cfg: SocioSegConfig, dtype=torch.bfloat16, device=None):
    """(config, tree) of seg_infer's model_name_or_path directory (read as
    SAM2-hiera-large), else a random SAM2-hiera-large seeded with 0."""
    path = cfg.seg_infer.model_args.model_name_or_path
    if path and os.path.isdir(path):
        return sloader.load_pretrained(path, dtype=dtype, device=device)
    device = param_device(device)
    sam_config = Sam2Config.large()
    params = smodel.init_params(sam_config, torch.Generator(device=device).manual_seed(0),
                                dtype=dtype, device=device)
    return sam_config, params


def load_dataset(cfg: SocioSegConfig, split: str, processor: SocioProcessor) -> List[Dict]:
    data_dir = (cfg.actor_train.data_args.dataset_dir
                or cfg.actor_train.data_args.file_name)
    rows = load_socioseg_dir(data_dir, split) if data_dir else []
    return [encode_sample(r, processor.image_config) for r in rows]


def default_engine_kwargs(cfg: SocioSegConfig) -> Dict:
    """DecodeEngine / TorchDecodeStrategy kwargs from the config: slots from
    actor_infer.infer_batch_size, the cache from sequence_length, and the
    strategy_config knobs (kv_quant, weight_quant, act_quant,
    single_copy_quant, vit_quant, prefix_fork). `sampler_exact` needs no
    kwarg: the port's sampler is always exact."""
    kwargs = {
        "max_slots": cfg.actor_infer.infer_batch_size,
        "max_len": cfg.sequence_length,
        "decode_chunk": 64,
        "prefill_buckets": (512, 1024, 2048, cfg.prompt_length),
        # large total-row buckets let several VLM requests (~1.5k image rows
        # each) share one batched prefill
        "image_buckets": (0, 512, 1024, 2048, 4096, 8192, 16384),
    }
    sc = cfg.actor_infer.strategy_args.strategy_config or {}
    for key in ("kv_quant", "weight_quant", "act_quant", "vit_quant"):
        if sc.get(key):
            kwargs[key] = sc[key]
    if sc.get("single_copy_quant"):
        kwargs["single_copy_quant"] = True
    if sc.get("prefix_fork") is not None:
        kwargs["prefix_fork"] = bool(sc["prefix_fork"])
    return kwargs


def build_infer_pipeline(cfg: SocioSegConfig, dtype=torch.bfloat16, device=None):
    from .socioseg_infer_pipeline import SocioSegInferPipeline
    model_config, params = load_policy(cfg, dtype, device)
    sam_config, sam_params = load_sam(cfg, dtype, device)
    processor = build_processor(cfg, model_config)
    dataset = load_dataset(cfg, "test", processor)
    return SocioSegInferPipeline(
        cfg, model_config=model_config, policy_params=params,
        sam_config=sam_config, sam_params=sam_params, processor=processor,
        dataset=dataset, engine_kwargs=default_engine_kwargs(cfg))


def build_train_mesh(cfg: SocioSegConfig):
    """The train plane's mesh on one GPU: validate_config, then None when
    every parallel knob of actor_train's strategy_config (tp, cp, pp, dp and
    fsdp_size, whose -1 takes the remaining devices) and its device_mapping
    resolve to one device. Anything larger raises: multi-GPU training is
    not ported yet."""
    validate_config(cfg, n_devices=1)
    wc = cfg.actor_train
    sc = wc.strategy_args.config
    mapping = wc.resolved_device_mapping()
    n = len(mapping) if mapping else 1
    sizes = {k: int(sc.get(k, 1) or 1) for k in (
        "tensor_model_parallel_size", "context_parallel_size",
        "pipeline_model_parallel_size", "dp_size")}
    fsdp = int(sc.get("fsdp_size", -1) or -1)
    sizes["fsdp_size"] = n if fsdp in (-1, 0) else fsdp
    big = {k: v for k, v in sizes.items() if v > 1}
    if n > 1 or big:
        raise NotImplementedError(
            f"actor_train on {n} devices with {big or sizes}: a train mesh is not "
            "ported yet (ROADMAP: multi-GPU)")
    return None


def build_train_pipeline(cfg: SocioSegConfig, dtype=torch.bfloat16, device=None):
    """SocioSegPipeline over the train split: the policy loaded twice (the
    reference is a frozen copy of the initial policy), SAM2 and the
    processor as for inference."""
    from .socioseg_pipeline import SocioSegPipeline
    build_train_mesh(cfg)
    model_config, params = load_policy(cfg, dtype, device)
    _, ref_params = load_policy(cfg, dtype, device)   # frozen copy of the initial policy
    sam_config, sam_params = load_sam(cfg, dtype, device)
    processor = build_processor(cfg, model_config)
    dataset = load_dataset(cfg, "train", processor)
    return SocioSegPipeline(
        cfg, model_config=model_config, policy_params=params,
        reference_params=ref_params, sam_config=sam_config,
        sam_params=sam_params, processor=processor, dataset=dataset,
        engine_kwargs=default_engine_kwargs(cfg))
