"""socioreasoner_tpu_torch — the PyTorch/CUDA port of socioreasoner_tpu.

The JAX package beside it is the reference: this package keeps its module
paths and public names so each counterpart is easy to find, and its tests hold
every module against the JAX function on the same inputs.

Layer map (the slices ported so far: stage-1 serving, the GRPO actor path,
quantized serving, SAM2 and the two-stage infer pipeline, the GRPO
pipeline, and the from-config start: loaders, checkpoints, entry scripts):
  examples                — the two entry scripts (yaml → pipeline → run())
  tools/convert           — HF <-> native checkpoint CLI
  configs                 — the yaml loader and the config dataclasses
  ops                     — attention references + hand-written Hopper kernels
                            (csrc/*.cu, built by ops/_build.py at first use),
                            the trainable flash attention (autograd Function)
  models/qwen2_5_vl       — ViT, text decoder (remat, trainable flash), full
                            model, weight bridge, HF loader and export
  models/sam2             — Hiera + FPN encoder, prompt encoder, two-way mask
                            decoder, predictor, HF loader
  generation              — DecodeEngine, sampling, GenerateServer
  datasets                — processor, SocioSeg encode_sample and stage-2
                            render, stage-1 and restage collators
  utils/functionals       — RL math (advantages, KL, aggregation) + host helpers
  pipeline/losses         — PPO/GRPO policy loss, value loss
  pipeline/rlvr           — SocioSegInferPipeline (two-stage infer, run()),
                            SocioSegPipeline (GRPO), build functions, parsing,
                            giou, mask_iou, rule rewards
  utils                   — safetensors reader/writer, CheckpointManager,
                            trackers, metrics, WorkerState
  distributed             — ParamStore and strategy bases, the train/logprob
                            steps and optimizer (trainer), batch_image_embeds,
                            TorchTrainStrategy / TorchInferStrategy /
                            TorchDecodeStrategy, SegStrategy (SAM2)

It imports torch, never jax, and nothing of the JAX package: the host-only
modules it needs (the Qwen2.5-VL and SAM2 configs, protocol, the configs,
datasets/processor, datasets/socioseg, parsing, MetricsManager, ...) are its
own copies. Its entry points (params_from_numpy, the init_params, the
loaders, the build functions, the entry scripts and the convert CLI) place tensors
on the GPU unless the caller names a device.
"""

__version__ = "0.1.0"
