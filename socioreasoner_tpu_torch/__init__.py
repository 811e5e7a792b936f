"""socioreasoner_tpu_torch — the PyTorch/CUDA port of socioreasoner_tpu.

The JAX package beside it is the reference: this package keeps its module
paths and public names so each counterpart is easy to find, and its tests hold
every module against the JAX function on the same inputs.

Layer map (the slices ported so far: stage-1 serving, the GRPO actor path,
quantized serving, SAM2 and the two-stage infer pipeline, the GRPO
pipeline, the from-config start: loaders, checkpoints, entry scripts, the
generic RLVR slice: RLVRPipeline with dynamic sampling, MathVLMPipeline,
the worker runtime with every reward, the reward model, the critic, SFT
and DPO, the other model families: MoE layers, the text-only LLM
families, the Qwen2-VL ViT, and the agentic slice):
  examples                — the two entry scripts (yaml → pipeline → run())
  tools/convert           — HF <-> native checkpoint CLI
  configs                 — the yaml loader and the config dataclasses
  ops                     — attention references + hand-written Hopper kernels
                            (csrc/*.cu, built by ops/_build.py at first use),
                            the trainable flash attention (autograd Function),
                            the MoE router and experts (ops/moe)
  models/qwen2_5_vl       — ViT (qwen2.5 and qwen2 variants), text decoder
                            (dense and MoE layers, remat, trainable flash),
                            full model, weight bridge, HF loader and export
  models/llm              — llama, mistral, qwen2, qwen3, qwen2_moe,
                            qwen3_moe and mixtral configs over the text
                            decoder, load_text_model
  models/sam2             — Hiera + FPN encoder, prompt encoder, two-way mask
                            decoder, predictor, HF loader
  generation              — DecodeEngine, sampling, GenerateServer
  runtime                 — Cluster (yaml worker_cls strings, the JAX
                            package's paths read as the port's), the dispatch
                            modes, Worker, GenerateScheduler,
                            DynamicSamplingScheduler, RequestScheduler,
                            LocalGenerateGroup
  datasets                — processor, SocioSeg encode_sample, stage-2
                            render and HF builder (load_socioseg), stage-1
                            and restage collators, the file loader and its
                            dataset-type registry, the stratified sampler,
                            the chat templates
  utils/functionals       — RL math (advantages, KL, aggregation), host
                            helpers, RunningMoments
  pipeline/losses         — PPO/GRPO policy loss, value loss
  pipeline/rlvr           — SocioSegInferPipeline (two-stage infer, run()),
                            SocioSegPipeline (GRPO), RLVRPipeline (multi-
                            domain GRPO, plain or dynamic-sampling rollout),
                            MathVLMPipeline, build functions, parsing, giou,
                            mask_iou, run_validation, compute_data_metrics,
                            the rewards (SocioSeg, math, code sandbox local
                            and remote, CrossThink-QA and validation, LLM
                            judge); pipeline/base_worker: the actor, SAM2,
                            rule-reward, reward-model and SocioSeg workers
  pipeline/agentic        — environments (guess_number, grid_goal), the
                            text rollout loop and EnvManager's multi-turn
                            episodes, AgenticPipeline, AgenticVLMPipeline,
                            AgenticRolloutPipeline
  utils                   — safetensors reader/writer, CheckpointManager,
                            trackers, metrics, WorkerState
  distributed             — ParamStore and strategy bases, the train/logprob,
                            critic and SFT steps and optimizer (trainer),
                            sequence packing and DPO (sft),
                            batch_image_embeds, compute_image_embeds,
                            TorchTrainStrategy / TorchInferStrategy /
                            TorchRewardStrategy / TorchDecodeStrategy,
                            SegStrategy (SAM2), create_strategy (factory)

It imports torch, never jax, and nothing of the JAX package: the host-only
modules it needs (the Qwen2.5-VL and SAM2 configs, protocol, the configs,
datasets/processor, datasets/socioseg, parsing, MetricsManager, ...) are its
own copies. Its entry points (params_from_numpy, the init_params, the
loaders, the build functions, the entry scripts and the convert CLI) place tensors
on the GPU unless the caller names a device.
"""

__version__ = "0.1.0"
