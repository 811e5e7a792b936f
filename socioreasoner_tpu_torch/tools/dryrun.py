"""Dry runs of the port over several devices, plane by plane.

    entry(device=None, config=None)          — the flagship forward step
    dryrun_multichip(n_devices, devices=None) — every sharded plane, one step each
    dryrun_multiprocess(n_processes=2)        — a global mesh over processes

The counterparts of the JAX package's entry points in `__graft_entry__.py` (`entry`,
`dryrun_multichip`, `dryrun_multiprocess`). Where the JAX package forces a
virtual CPU mesh, the port takes a device list in which one device may
repeat: `dryrun_multichip(8, [torch.device("cpu")] * 8)` on the CPU, or
eight entries of one card. The planes:

  * the GRPO train step over a dp x fsdp x tp mesh;
  * the MoE model's forward and gradient with the experts over tp;
  * context parallelism over sp = 2: the zigzag ring, then Ulysses, their
    losses within 1e-3 of each other;
  * pipeline parallelism over pp = 2 (GPipe);
  * the tensor-parallel decode engine: two equal prompts, the second forked
    from the first's cache, the same greedy tokens;
  * one SocioSegPipeline GRPO step with actor_train over the mesh
    ResourceManager lays and two decode replicas, its loss held to a fresh
    unsharded strategy's on the same mini-batch;
  * `dryrun_multiprocess`: processes joined through runtime/initialize.py
    (gloo), each the controller of its dp rows of one global mesh, running
    a train step, the log-probs and a decode replica of its own; their
    losses must be equal.

On a CUDA device the text widths are ones the kernels take (head dim 128,
the ViT's 80) in bfloat16; on the CPU they are Qwen25VLConfig.tiny()'s in
float32. Run from the root of the repository:

    python -m socioreasoner_tpu_torch.tools.dryrun --n_devices 8 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import types
from typing import Optional, Sequence

import numpy as np
import torch

VOCAB = 512


def _device(device=None) -> torch.device:
    """The named device, else the card (raises without one)."""
    from ..models.qwen2_5_vl.convert import param_device
    return param_device(device)


def dryrun_config(device, vocab: int = VOCAB):
    """(config, dtype) of the dry runs on `device`: Qwen25VLConfig.tiny() in
    float32 on the CPU; on a card the same layout at widths the kernels
    take (text 4/2 heads x 128, ViT 2 heads x 80) in bfloat16."""
    from ..models.qwen2_5_vl.config import Qwen25VLConfig, TextConfig, VisionConfig
    if torch.device(device).type != "cuda":
        return Qwen25VLConfig.tiny(vocab), torch.float32
    return Qwen25VLConfig(
        vision=VisionConfig(depth=4, hidden_size=160, intermediate_size=320, num_heads=2,
                            out_hidden_size=256, window_size=28, fullatt_block_indexes=(1, 3)),
        text=TextConfig(vocab_size=vocab, hidden_size=256, intermediate_size=512,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        head_dim=128, mrope_section=(16, 24, 24), tie_word_embeddings=False),
        image_token_id=vocab - 3, video_token_id=vocab - 2, vision_start_token_id=vocab - 4,
        bos_token_id=0, eos_token_id=1, pad_token_id=0), torch.bfloat16


def entry(device=None, config=None):
    """(fn, args): the flagship model's forward (Qwen2.5-VL-3B's layer
    widths, 4 layers, vocab 151936, bfloat16 random weights; `config`
    replaces it) on B=1 x L=256 random tokens; fn(*args) gives the logits."""
    from ..models.qwen2_5_vl import model as qmodel
    from ..models.qwen2_5_vl import rope as qrope
    from ..models.qwen2_5_vl.config import Qwen25VLConfig, TextConfig, VisionConfig
    dev = _device(device)
    config = config or Qwen25VLConfig(
        vision=VisionConfig(depth=4, fullatt_block_indexes=(3,)),
        text=TextConfig(num_hidden_layers=4, vocab_size=151936))
    params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(0),
                                dtype=torch.bfloat16, device=dev, with_vision=False)
    B, L = 1, 256
    rng = np.random.default_rng(0)
    ids = rng.integers(10, min(1000, config.text.vocab_size), size=(B, L))
    attn = np.ones((B, L), np.int64)
    pos, _ = qrope.get_rope_index(config, ids, None, attn)

    @torch.no_grad()
    def fn(params, input_ids, position_ids, attention_mask):
        logits, _ = qmodel.forward(config, params, input_ids, position_ids, attention_mask)
        return logits

    return fn, (params, *(torch.as_tensor(a, device=dev) for a in (ids, pos, attn)))


def _grpo_batch(config, B: int, L: int, seed: int = 0):
    """A GRPO batch of full rows, responses in the second half."""
    from ..models.qwen2_5_vl import rope as qrope
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 200, size=(B, L))
    attn = np.ones((B, L), np.int64)
    pos, _ = qrope.get_rope_index(config, ids, None, attn)
    resp = np.zeros((B, L), np.int64)
    resp[:, L // 2:] = 1
    return {"input_ids": ids, "attention_mask": attn, "position_ids": pos,
            "response_mask": resp,
            "advantages": rng.normal(size=(B, L - 1)).astype(np.float32),
            "old_log_probs": (-np.abs(rng.normal(size=(B, L - 1)))).astype(np.float32),
            "ref_log_probs": (-np.abs(rng.normal(size=(B, L - 1)))).astype(np.float32)}


def _step_loss(config, params, mesh, batch, dev, **plan) -> float:
    """One GRPO train step of `params` (copied into the mesh's shards) with
    the given cp / pp plan; returns the total loss."""
    from ..distributed.trainer import TrainState, make_optimizer, make_train_step
    from ..parallel.sharding import ShardedTree
    from ..pipeline.losses import PPOLossConfig
    pp = plan.get("pp")
    stages = None if pp is None else pp.stage_layers(config.text.num_hidden_layers)
    optimizer = make_optimizer(lr=1e-4)
    state = TrainState.create(ShardedTree(params, mesh, layer_stages=stages), optimizer)
    step = make_train_step(config, PPOLossConfig(), optimizer, remat=True, **plan)
    state, metrics = step(state, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    loss = float(metrics["actor_train/total_loss"])
    if not np.isfinite(loss) or state.step != 1:
        raise AssertionError(f"train step: loss {loss}, step {state.step}")
    return loss


def _moe_plane(mesh, tp: int, dev, B: int, L: int) -> float:
    """The MoE model over the mesh (experts over tp): forward, aux loss and
    the gradient of the expert stacks (dense attention, as in JAX's plane)."""
    from ..models.qwen2_5_vl import model as qmodel
    from ..models.qwen2_5_vl.config import Qwen25VLConfig, TextConfig, VisionConfig
    from ..parallel.sharding import ShardedTree
    moe_config = Qwen25VLConfig(
        vision=VisionConfig(depth=1, hidden_size=16, intermediate_size=32,
                            num_heads=2, out_hidden_size=32),
        text=TextConfig(vocab_size=128, hidden_size=32, intermediate_size=16,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=8,
                        mrope_section=(2, 1, 1), tie_word_embeddings=False,
                        n_experts=max(tp, 2) * 2, n_experts_per_tok=2),
        bos_token_id=0, eos_token_id=1, pad_token_id=0)
    sharded = ShardedTree(qmodel.init_params(moe_config, torch.Generator(device=dev)
                                             .manual_seed(1), device=dev,
                                             with_vision=False), mesh)
    rng = np.random.default_rng(1)
    mids = torch.as_tensor(rng.integers(2, 100, (B, L)), device=dev)
    mpos = torch.arange(L, device=dev)[None, None].expand(B, 3, L)
    blocks = sharded.blocks()
    for b in blocks:
        b.requires_grad_(True)
    try:
        ranks, rows = sharded.data_ranks(B)
        logits, aux = qmodel.forward_mesh(moe_config, ranks, rows, mids, mpos)
        home = ranks[0].home
        nll = 0.0
        for out, sl in zip(logits, rows):
            lp = torch.log_softmax(out[:, :-1].float(), dim=-1).to(home)
            nll = nll - lp.gather(-1, mids[sl, 1:, None].to(home)).sum()
        loss = nll / (B * (L - 1)) + 0.01 * aux["moe_aux"]
        gate = sharded["layers"]["gate_w"].tensors()
        grads = torch.autograd.grad(loss, gate)
    finally:
        for b in blocks:
            b.requires_grad_(False)
    loss = float(loss.detach())
    if not np.isfinite(loss) or not sum(float(g.abs().sum()) for g in grads) > 0:
        raise AssertionError(f"MoE plane: loss {loss}, expert gradients zero")
    return loss


def _decode_plane(config, dtype, devices) -> int:
    """A head-sharded engine over tp = 2 serving two equal prompts: the
    second must fork from the first's cache and give the same greedy
    tokens. Returns the forks."""
    from ..generation.engine import DecodeEngine, Request
    from ..generation.sampling import SamplingParams
    from ..models.qwen2_5_vl import model as qmodel
    dev = devices[0]
    params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(5),
                                dtype=dtype, device=dev, with_vision=False)
    eng = DecodeEngine(config, params, max_slots=2, max_len=64, decode_chunk=4,
                       prefill_buckets=(16,), cache_dtype=dtype, mesh=list(devices[:2]))
    prompt = np.random.default_rng(2).integers(2, 200, size=7).tolist()
    sp = SamplingParams(temperature=0.0, do_sample=False, max_new_tokens=4)
    outs = eng.generate([Request(request_id=i, prompt_ids=list(prompt), sampling=sp)
                         for i in range(2)])
    if eng.forked_requests < 1 or outs[0].output_ids != outs[1].output_ids:
        raise AssertionError(f"tp decode: {eng.forked_requests} forks, "
                             f"{[o.output_ids for o in outs]}")
    return eng.forked_requests


# Two canned response variants with different reward profiles (the GT mask
# holds one object at [20, 50)²): A matches the count and the box, B
# over-counts off target. The tokenizer cycles them, so GRPO siblings score
# differently, the advantages are non-zero and the step carries gradient.
_VARIANTS = (
    '<think>one block</think>\n<answer>[{"bbox_2d": [20, 20, 50, 50], '
    '"points": [[30, 30], [40, 40]]}]</answer>',
    '<think>many blocks</think>\n<answer>['
    '{"bbox_2d": [60, 60, 90, 90], "points": [[70, 70], [80, 80]]}, '
    '{"bbox_2d": [0, 0, 15, 15], "points": [[5, 5], [10, 10]]}, '
    '{"bbox_2d": [60, 0, 90, 15], "points": [[70, 5], [80, 10]]}]'
    '</answer>')


def _tokenizer():
    from ..datasets.processor import SimpleTokenizer

    class TinyTok(SimpleTokenizer):
        def __init__(self):
            super().__init__(vocab_size=VOCAB)
            self.special = {
                "<|im_start|>": 300, "<|im_end|>": 1,
                "<|vision_start|>": VOCAB - 4, "<|vision_end|>": VOCAB - 1,
                "<|image_pad|>": VOCAB - 3, "<|video_pad|>": VOCAB - 2,
                "<|endoftext|>": 0,
            }
            self.id_to_special = {v: k for k, v in self.special.items()}
            self.pad_token_id = 0
            self.eos_token_id = 1
            self._decode_calls = 0

        def decode(self, ids, skip_special_tokens=False):
            # responses only (the pipelines never decode prompts)
            self._decode_calls += 1
            return _VARIANTS[self._decode_calls % 2]
    return TinyTok()


def _pipeline_plane(devices, out_dir: str) -> float:
    """One SocioSegPipeline GRPO step (stage-1 decode, SAM2, restage,
    stage-2 decode, SAM2, rewards, advantages, the sharded train steps) with
    actor_train over ResourceManager's mesh (tensor_model_parallel_size 2
    when the devices are even) and two decode replicas; the first train
    mini-batch replayed through a fresh unsharded strategy must give the
    same loss within 1e-3 of its size."""
    from PIL import Image
    from ..configs.rlvr_config import SocioSegConfig
    from ..datasets.processor import ImageProcessorConfig, SocioProcessor
    from ..datasets.socioseg import encode_sample
    from ..distributed.strategy import ParamStore
    from ..distributed.torch_strategies import TorchTrainStrategy
    from ..models.qwen2_5_vl import model as qmodel
    from ..models.sam2 import model as smodel
    from ..models.sam2.config import Sam2Config
    from ..pipeline.losses import PPOLossConfig
    from ..pipeline.rlvr.socioseg_pipeline import SocioSegPipeline
    from ..runtime.resource_manager import ResourceManager

    dev = devices[0]
    model_config, dtype = dryrun_config(dev)
    img_cfg = ImageProcessorConfig(min_pixels=56 * 56, max_pixels=56 * 56 * 4)
    processor = SocioProcessor(_tokenizer(), img_cfg,
                               image_token_id=model_config.image_token_id)
    rng = np.random.default_rng(0)
    tiles = []
    for i in range(2):
        m = np.zeros((96, 96), np.uint8)
        m[20:50, 20:50] = 255
        tiles.append({"id": f"t{i}", "question": "residential area",
                      "map": Image.fromarray(rng.integers(0, 255, (96, 96, 3), dtype=np.uint8)),
                      "sat": Image.fromarray(rng.integers(0, 255, (96, 96, 3), dtype=np.uint8)),
                      "mask": Image.fromarray(m)})
    dataset = [encode_sample(t, img_cfg) for t in tiles]

    cfg = SocioSegConfig(
        output_dir=out_dir, rollout_batch_size=2, prompt_length=640,
        response_length=16, save_steps=-1, track_with="stdout", max_steps=1,
        num_return_sequences_in_group=2, adv_estimator="grpo",
        use_kl_loss=True, kl_loss_coef=5e-3)
    cfg.actor_infer.generating_args.max_new_tokens = 4
    cfg.actor_infer.generating_args.num_return_sequences = 2
    cfg.actor_train.backward_batch_size = 4
    cfg.actor_train.strategy_args.strategy_name = "jax_train"
    tp = 2 if len(devices) % 2 == 0 else 1
    cfg.actor_train.strategy_args.strategy_config = {"tensor_model_parallel_size": tp}
    cfg.actor_infer.strategy_args.strategy_name = "jax_decode"
    n_rep = 2 if len(devices) >= 2 else 1
    cfg.actor_infer.strategy_args.strategy_config = {"dp_size": n_rep}
    cfg.seg_infer.strategy_args.strategy_name = "seg_infer"

    def tree(seed, vision=True):
        return qmodel.init_params(model_config, torch.Generator(device=dev).manual_seed(seed),
                                  dtype=dtype, device=dev, with_vision=vision)

    mesh = ResourceManager(devices).allocate_mesh("actor_train", cfg.actor_train)
    sam_config = Sam2Config.tiny_test()
    pipe = SocioSegPipeline(
        cfg, model_config=model_config, policy_params=tree(0),
        # the reference seeded differently from the policy, so the KL term
        # is non-zero
        reference_params=tree(7), sam_config=sam_config,
        sam_params=smodel.init_params(sam_config, torch.Generator(device=dev).manual_seed(1),
                                      dtype=dtype, device=dev),
        processor=processor, dataset=dataset,
        engine_kwargs={"max_slots": 4, "max_len": 700, "decode_chunk": 4,
                       "prefill_buckets": (640,), "image_buckets": (0, 16, 32),
                       "cache_dtype": dtype}, devices=list(devices), mesh=mesh)
    if len(pipe.decode_replicas) != n_rep:
        raise AssertionError(f"{len(pipe.decode_replicas)} decode replicas, want {n_rep}")

    recorded = {}
    train_step = pipe.actor_train.train_step

    def recording(mini, *a, **k):
        m = train_step(mini, *a, **k)
        recorded.setdefault("batch", mini)
        recorded.setdefault("metrics", m)
        return m
    pipe.actor_train.train_step = recording
    metrics = pipe.run()
    loss = float(metrics["map/actor_train/total_loss"])
    # a degenerate rollout (errored requests, empty responses) must fail
    if not (np.isfinite(loss) and metrics.get("system/actor_infer/tps", 0.0) > 0.0):
        raise AssertionError(f"pipeline: loss {loss}, "
                             f"tps {metrics.get('system/actor_infer/tps')}")
    grad_norm = float(metrics["map/actor_train/grad_norm"])
    kl_loss = float(metrics["map/actor_train/kl_loss"])
    if not (grad_norm > 0.0 and kl_loss != 0.0):
        raise AssertionError(f"pipeline: grad_norm {grad_norm}, kl_loss {kl_loss}")
    if mesh is not None:
        solo = TorchTrainStrategy(worker_config=cfg.actor_train, param_store=ParamStore())
        solo.initialize(model_config, tree(0), PPOLossConfig(
            pg_clip=cfg.pg_clip, dual_clip_loss=cfg.dual_clip_loss,
            use_kl_loss=cfg.use_kl_loss, kl_loss_coef=cfg.kl_loss_coef,
            entropy_loss_coef=cfg.entropy_loss_coef, loss_agg_mode=cfg.loss_agg_mode),
            cfg.actor_train.training_args, mesh=None)
        solo_loss = solo.train_step(recorded["batch"])["actor_train/total_loss"]
        mesh_loss = recorded["metrics"]["actor_train/total_loss"]
        if not abs(mesh_loss - solo_loss) <= 1e-3 * max(1.0, abs(solo_loss)):
            raise AssertionError(f"meshed loss {mesh_loss} != one device's {solo_loss}")
    return loss


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Every sharded plane of the port over `n_devices` of `devices` (default:
    the visible CUDA devices; one device may be listed several times), one
    step each. Raises on any failure; returns the planes' figures."""
    from ..models.qwen2_5_vl import model as qmodel
    from ..parallel.context_parallel import CPConfig
    from ..parallel.mesh import default_devices, make_mesh
    from ..parallel.pipeline_parallel import PPConfig

    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices())]
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}: list one "
                         "device several times to run the sharded code on it")
    devices = devices[:n_devices]
    dev = devices[0]
    config, dtype = dryrun_config(dev)

    def params(seed):
        return qmodel.init_params(config, torch.Generator(device=dev).manual_seed(seed),
                                  dtype=dtype, device=dev, with_vision=False)

    # dp x fsdp x tp: tp 2 when the devices are even, dp 2 from 8 up, the rest fsdp
    tp = 2 if n_devices % 2 == 0 else 1
    rem = n_devices // tp
    dp = 2 if rem % 2 == 0 and rem >= 2 else 1
    fsdp = rem // dp
    mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp, devices=devices)
    B, L = dp * fsdp * 2, 16
    batch = _grpo_batch(config, B, L)
    out = {"mesh": mesh.shape, "loss": _step_loss(config, params(0), mesh, batch, dev)}
    out["moe_loss"] = _moe_plane(mesh, tp, dev, B, L)

    if n_devices % 2 == 0:
        cp_tp = 2 if n_devices % 4 == 0 else 1
        cp_mesh = make_mesh(fsdp=n_devices // (2 * cp_tp), tp=cp_tp, sp=2, devices=devices)
        out["cp_loss"] = _step_loss(config, params(2), cp_mesh, batch, dev,
                                    cp=CPConfig(mesh=cp_mesh, size=2))
        out["ulysses_loss"] = _step_loss(config, params(2), cp_mesh, batch, dev,
                                         cp=CPConfig(mesh=cp_mesh, size=2, impl="ulysses"))
        if not abs(out["ulysses_loss"] - out["cp_loss"]) < 1e-3:
            raise AssertionError(f"ring vs ulysses loss: {out['cp_loss']} vs "
                                 f"{out['ulysses_loss']}")
        pp_mesh = make_mesh(fsdp=n_devices // 2, pp=2, devices=devices)
        out["pp_loss"] = _step_loss(config, params(3), pp_mesh, batch, dev,
                                    pp=PPConfig(mesh=pp_mesh, size=2))
        out["tp_decode_forks"] = _decode_plane(config, dtype, devices)
    with tempfile.TemporaryDirectory() as out_dir:
        out["socioseg_pipeline_loss"] = _pipeline_plane(devices, out_dir)
    print("dryrun_multichip OK: " + json.dumps(out), flush=True)
    return out


# ------------------------------------------------------------------ processes

def _worker(device: str, per_process_devices: int) -> int:
    """One process of dryrun_multiprocess: joins the process group, builds
    its dp rows of the global dp (= processes) x fsdp x tp mesh, runs a
    train step, the log-probs and its own decode replica, and prints one
    JSON line."""
    from ..configs.worker_config import WorkerConfig
    from ..distributed.strategy import ParamStore
    from ..distributed.torch_strategies import TorchInferStrategy, TorchTrainStrategy
    from ..generation.engine import DecodeEngine, Request
    from ..generation.sampling import SamplingParams
    from ..models.qwen2_5_vl import model as qmodel
    from ..parallel.mesh import make_mesh
    from ..pipeline.losses import PPOLossConfig
    from ..protocol import BatchProto
    from ..runtime import initialize
    from ..utils.collective import broadcast_host_data

    torch.set_num_threads(1)
    initialize.init(timeout_s=300)
    import torch.distributed as dist
    rank, world = initialize.get_driver_rank(), initialize.get_driver_world_size()
    dev = torch.device(device)
    config, dtype = dryrun_config(dev)
    tp = 2 if per_process_devices % 2 == 0 else 1
    mesh = make_mesh(dp=world, fsdp=per_process_devices // tp, tp=tp,
                     devices=[dev] * per_process_devices, process_index=rank,
                     process_count=world)
    params = qmodel.init_params(config, torch.Generator(device=dev).manual_seed(0),
                                dtype=dtype, device=dev, with_vision=False)
    B, L = 4, 32
    batch = BatchProto.from_dict(tensors=_grpo_batch(config, B, L))
    store = ParamStore()
    train = TorchTrainStrategy(worker_config=WorkerConfig(), param_store=store)
    train.initialize(config, params, PPOLossConfig(use_kl_loss=True, kl_loss_coef=5e-3),
                     training_args=types.SimpleNamespace(learning_rate=1e-6), mesh=mesh)
    ref = TorchInferStrategy(worker_config=WorkerConfig(), param_store=store)
    ref.initialize(config, params, mesh=mesh)
    lp = ref.compute_log_probs(batch)["log_probs"]
    metrics = train.train_step(batch)
    loss = metrics["actor_train/loss"]
    engine = DecodeEngine(config, train.state.params.gather(dev), max_slots=2, max_len=64,
                          decode_chunk=4, prefill_buckets=(32,), cache_dtype=dtype)
    ids = batch.batch["input_ids"]
    outs = engine.generate([Request(request_id=(rank, i), prompt_ids=ids[i, :16].tolist(),
                                    sampling=SamplingParams(max_new_tokens=4))
                            for i in range(2)])
    loss0 = broadcast_host_data(loss, src=0)
    print(json.dumps({"rank": rank, "backend": dist.get_backend(), "loss": loss,
                      "loss_repr": repr(loss), "loss_of_rank0": loss0,
                      "log_probs_finite": bool(np.isfinite(lp).all()),
                      "log_probs_shape": list(lp.shape), "mesh": mesh.shape,
                      "decoded": [len(o.output_ids) for o in outs]}), flush=True)
    dist.destroy_process_group()
    return 0


def dryrun_multiprocess(n_processes: int = 2, per_process_devices: int = 4, device=None,
                        timeout: float = 600) -> list:
    """Start `n_processes` processes of this module's worker (gloo, every
    process on `device` -- the card unless one is named -- listed
    per_process_devices times), joined through RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT; each runs a GRPO train step, the log-probs
    and a decode replica over the global dp x fsdp x tp mesh. Raises when a
    process fails or their losses differ; returns their JSON lines."""
    dev = _device(device)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(n_processes):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n_processes),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "socioreasoner_tpu_torch.tools.dryrun", "--worker",
             "--device", str(dev), "--per_process_devices", str(per_process_devices)],
            cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"dryrun_multiprocess rank {rank} failed:\n{out[-4000:]}")
        results.append(json.loads(lines[-1]))
    losses = {r["loss_repr"] for r in results}
    if len(losses) != 1 or not all(r["log_probs_finite"] and min(r["decoded"]) >= 1
                                   for r in results):
        raise AssertionError(f"dryrun_multiprocess: {results}")
    print(f"dryrun_multiprocess OK: {n_processes} processes x {per_process_devices} "
          f"devices, loss={results[0]['loss']}", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_devices", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--processes", type=int, default=0,
                    help="run dryrun_multiprocess with this many processes instead")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--per_process_devices", type=int, default=4)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args.device, args.per_process_devices)
    if args.processes:
        dryrun_multiprocess(args.processes, args.per_process_devices, args.device)
        return 0
    dryrun_multichip(args.n_devices, [_device(args.device)] * args.n_devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
