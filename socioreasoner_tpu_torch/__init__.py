"""socioreasoner_tpu_torch — the PyTorch/CUDA port of socioreasoner_tpu.

The JAX package beside it is the reference: this package keeps its module
paths and public names so each counterpart is easy to find, and its tests hold
every module against the JAX function on the same inputs.

Layer map (the slices ported so far: stage-1 serving, the GRPO actor path,
quantized serving):
  ops                     — attention references + hand-written Hopper kernels
                            (csrc/*.cu, built by ops/_build.py at first use),
                            the trainable flash attention (autograd Function)
  models/qwen2_5_vl       — ViT, text decoder (remat, trainable flash), full
                            model, weight bridge
  generation              — DecodeEngine, sampling, GenerateServer
  datasets                — processor, SocioSeg encode_sample, stage-1 collator
  utils/functionals       — RL math (advantages, KL, aggregation) + host helpers
  pipeline/losses         — PPO/GRPO policy loss, value loss
  distributed             — ParamStore and strategy bases, the train/logprob
                            steps and optimizer (trainer), batch_image_embeds,
                            TorchTrainStrategy / TorchInferStrategy /
                            TorchDecodeStrategy

It imports torch, never jax, and nothing of the JAX package: the host-only
modules it needs (the Qwen2.5-VL config, protocol, configs/worker_config,
datasets/processor and the stage-1 part of datasets/socioseg) are its own
copies. Its entry points (params_from_numpy, init_params) place tensors on
the GPU unless the caller names a device.
"""

__version__ = "0.1.0"
