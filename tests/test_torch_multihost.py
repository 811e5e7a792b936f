"""Two processes of the port over torch.distributed (gloo on the CPU),
mirroring tests/test_multihost.py.

The parent test computes JAX's in-process JaxTrainStrategy step over
make_mesh(dp=2, fsdp=2, tp=2) on the run's 8 virtual devices, writes the
weights and the batch as an .npz, then starts two processes of this file's
__main__ block (once for the whole file). Each process joins through
runtime/initialize.py, broadcasts a tensor and a host object, reduces over
the mesh's dp axis, runs one GRPO train step over a global dp 2 x fsdp 2 x
tp 2 mesh (its 4 local "devices" are cpu entries, dp split over the two
processes) and serves a per-process decode replica; it prints one JSON
line. The workers import no jax: only this file's tests do.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 4, 32


def _batch():
    """The batch of tests/_multihost_train_worker.py."""
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 400, size=(B, L))
    resp = np.zeros((B, L), np.int64)
    resp[:, L // 2:] = 1
    return {
        "input_ids": ids,
        "attention_mask": np.ones((B, L), np.int64),
        "position_ids": np.tile(np.arange(L)[None, None], (B, 3, 1)),
        "response_mask": resp,
        "advantages": rng.normal(size=(B, L - 1)).astype(np.float32),
        "old_log_probs": -np.abs(rng.normal(size=(B, L - 1))).astype(np.float32),
        "ref_log_probs": -np.abs(rng.normal(size=(B, L - 1))).astype(np.float32),
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_loss_one_process(data):
    """The port's step over the same mesh shape in one process."""
    import torch
    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig
    from socioreasoner_tpu_torch.parallel.mesh import make_mesh
    return _train_step(Qwen25VLConfig.tiny(512), data,
                       make_mesh(dp=2, fsdp=2, tp=2, devices=[torch.device("cpu")] * 8))


def _train_step(config, data, mesh):
    from socioreasoner_tpu_torch.configs.worker_config import WorkerConfig
    from socioreasoner_tpu_torch.distributed.strategy import ParamStore
    from socioreasoner_tpu_torch.distributed.torch_strategies import TorchTrainStrategy
    from socioreasoner_tpu_torch.models.qwen2_5_vl.convert import params_from_numpy
    from socioreasoner_tpu_torch.pipeline.losses import PPOLossConfig
    from socioreasoner_tpu_torch.protocol import BatchProto
    from socioreasoner_tpu_torch.utils.checkpoint import unflatten
    params = params_from_numpy(unflatten({k[2:]: data[k] for k in data if k.startswith("p:")}),
                               "cpu")
    batch = BatchProto.from_dict(tensors={k[2:]: data[k] for k in data if k.startswith("b:")})
    train = TorchTrainStrategy(worker_config=WorkerConfig(), param_store=ParamStore())
    train.initialize(config, params, PPOLossConfig(use_kl_loss=True, kl_loss_coef=5e-3),
                     mesh=mesh)
    return train, train.train_step(batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's loss, the port's one-process loss, and the two workers'
    outputs (the workers started once for the file)."""
    import jax
    import jax.numpy as jnp
    from socioreasoner_tpu.configs.worker_config import WorkerConfig as JWC
    from socioreasoner_tpu.distributed.jax_strategies import JaxTrainStrategy
    from socioreasoner_tpu.distributed.strategy import ParamStore as JStore
    from socioreasoner_tpu.models.qwen2_5_vl import model as j_model
    from socioreasoner_tpu.models.qwen2_5_vl.config import Qwen25VLConfig
    from socioreasoner_tpu.parallel.mesh import make_mesh
    from socioreasoner_tpu.pipeline.losses import PPOLossConfig
    from socioreasoner_tpu.protocol import BatchProto
    config = Qwen25VLConfig.tiny(512)
    params = jax.tree.map(np.asarray, j_model.init_params(config, jax.random.key(0),
                                                          jnp.float32, with_vision=False))
    batch = _batch()
    jtrain = JaxTrainStrategy(worker_config=JWC(), param_store=JStore())
    jtrain.initialize(config, jax.tree.map(jnp.asarray, params),
                      PPOLossConfig(use_kl_loss=True, kl_loss_coef=5e-3),
                      mesh=make_mesh(dp=2, fsdp=2, tp=2))
    jax_loss = jtrain.train_step(BatchProto.from_dict(tensors=dict(batch)))["actor_train/loss"]
    data = {**{"p:" + k: v for k, v in _flat(params).items()},
            **{"b:" + k: v for k, v in batch.items()}}
    path = str(tmp_path_factory.mktemp("multihost") / "world.npz")
    np.savez(path, **data)

    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), path],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        results.append(json.loads(line))
    one = _port_loss_one_process(dict(np.load(path)))[1]["actor_train/loss"]
    return {"jax": float(jax_loss), "one_process": one, "workers": results}


def test_two_process_init_and_broadcast(runs):
    """Both processes join over gloo; rank 0's tensor and host object reach
    rank 1; the dp all-reduce sums both processes' values; is_driver is
    rank 0 only."""
    w0, w1 = runs["workers"]
    assert w0["backend"] == w1["backend"] == "gloo"
    assert w0["rank"] == 0 and w1["rank"] == 1
    assert w0["is_driver"] and not w1["is_driver"]
    assert w0["broadcast"] == w1["broadcast"] == [0.0, 1.0, 2.0]
    assert w0["host"] == w1["host"] == {"from": 0, "items": [1, 2, 3]}
    # each process holds 1 of dp's 2 rows, valued 1 + its rank
    assert w0["allreduce"] == w1["allreduce"] == 1 + 2


def test_two_process_grpo_train_step(runs):
    """One GRPO step over the global dp 2 x fsdp 2 x tp 2 mesh: both ranks'
    losses bit-equal, within 1e-5 of JAX's in-process JaxTrainStrategy over
    the same mesh shape and of the port's one-process step; the grad norms
    equal."""
    w0, w1 = runs["workers"]
    assert w0["loss_repr"] == w1["loss_repr"]
    assert w0["grad_norm_repr"] == w1["grad_norm_repr"]
    np.testing.assert_allclose(w0["loss"], runs["jax"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w0["loss"], runs["one_process"], rtol=1e-5, atol=1e-6)
    assert w0["mesh_shape"] == {"dp": 2, "fsdp": 2, "pp": 1, "sp": 1, "tp": 2}
    assert w0["params_equal_across_ranks"]


def test_two_process_decode_replicas(runs):
    """Each process serves its own decode replica on its local device; no
    worker loaded jax or the JAX package."""
    for w in runs["workers"]:
        assert w["jax_modules"] == []
        assert w["decoded"] == 2 and w["min_new_tokens"] >= 1


def _worker(path: str) -> int:
    """One process of the two-process run (imports no jax)."""
    import torch
    torch.set_num_threads(1)
    from socioreasoner_tpu_torch.runtime import initialize
    from socioreasoner_tpu_torch.utils import collective
    initialize.init(timeout_s=120)
    import torch.distributed as dist
    rank = initialize.get_driver_rank()
    assert collective.process_count() == 2 and collective.process_index() == rank

    from socioreasoner_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig
    from socioreasoner_tpu_torch.parallel.mesh import make_mesh
    cpu = torch.device("cpu")
    mesh = make_mesh(dp=2, fsdp=2, tp=2, devices=[cpu] * 4, process_index=rank,
                     process_count=2)
    value = torch.arange(3.0) if rank == 0 else torch.zeros(3)
    got = collective.broadcast(value, mesh, "dp", src=0)
    host = collective.broadcast_host_data({"from": rank, "items": [1, 2, 3]}, src=0)
    summed = collective.allreduce([torch.tensor(1.0 + rank)] * mesh.local_shape["dp"],
                                  mesh, "dp")
    collective.barrier()

    data = dict(np.load(path))
    config = Qwen25VLConfig.tiny(512)
    train, metrics = _train_step(config, data, mesh)
    sums = torch.stack([b.double().sum() for b in train.state.params.blocks()])
    all_sums = [torch.zeros_like(sums) for _ in range(2)]
    dist.all_gather(all_sums, sums)

    from socioreasoner_tpu_torch.generation.engine import DecodeEngine, Request
    from socioreasoner_tpu_torch.generation.sampling import SamplingParams
    ids = data["b:input_ids"]
    engine = DecodeEngine(config, train.state.params.gather(cpu), max_slots=2, max_len=64,
                          decode_chunk=4, prefill_buckets=(32,), cache_dtype=torch.float32)
    outs = engine.generate([Request(request_id=(rank, i), prompt_ids=ids[i, :16].tolist(),
                                    sampling=SamplingParams(max_new_tokens=4))
                            for i in range(2)])
    print(json.dumps({
        "rank": rank, "backend": dist.get_backend(), "is_driver": initialize.is_driver(),
        "broadcast": got.tolist(), "host": host, "allreduce": float(summed[0]),
        "loss": metrics["actor_train/loss"], "loss_repr": repr(metrics["actor_train/loss"]),
        "grad_norm_repr": repr(metrics["actor_train/grad_norm"]),
        "mesh_shape": mesh.shape,
        "params_equal_across_ranks": bool(torch.equal(all_sums[0], all_sums[1])),
        "decoded": len(outs), "min_new_tokens": min(len(o.output_ids) for o in outs),
        "jax_modules": sorted(m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "socioreasoner_tpu.")))}),
        flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
