"""The port's MoE layer (socioreasoner_tpu_torch.ops.moe) against the JAX
package's on the same seeded numpy inputs: router weights, probabilities
and the load-balance loss and the expert MLP's output in float32, and
every gradient against jax.grad on float64 inputs (rtol 1e-5, atol 1e-6
of each tensor's scale; the router's own gradient to 1e-4 of its scale:
the router computes in float32 whatever the input dtype, as in JAX, and
the two float32 softmax backwards differ by up to ~1.2e-5 of its scale),
for norm_topk_prob both ways and top-k 1, 2 and E; the tie rule of
lax.top_k (the lower expert index first) on exactly tied router columns;
and init_moe_params' shapes, dtype and spread."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from socioreasoner_tpu.ops import moe as j_moe
from socioreasoner_tpu_torch.ops import moe as t_moe

T, H, I, E = 24, 16, 8, 6


@pytest.fixture(scope="module", autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _close(got, want, rtol=1e-5, atol=1e-6):
    """got within rtol of want, or atol of want's largest magnitude."""
    want = np.asarray(want)
    assert got.dtype == (torch.float64 if want.dtype == np.float64 else torch.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol * scale)


ROUTER_GRAD_ATOL = 1e-4


def _inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, H)).astype(dtype)
    p = {"router_w": rng.normal(size=(H, E)).astype(dtype),
         "gate_w": (rng.normal(size=(E, H, I)) * 0.3).astype(dtype),
         "up_w": (rng.normal(size=(E, H, I)) * 0.3).astype(dtype),
         "down_w": (rng.normal(size=(E, I, H)) * 0.3).astype(dtype)}
    return x, p


def _both(x, p, top_k, norm, cot, aux_w=0.7):
    """(JAX's and the port's) (router outputs, mlp output, aux, grads of
    sum(out * cot) + aux_w * aux with respect to x and every leaf)."""
    def j_loss(x, p):
        out, aux = j_moe.moe_mlp(x, p, top_k, norm)
        return jnp.sum(out * cot) + aux_w * aux

    jx, jp = jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}
    j_router = j_moe.moe_router(jx, jp["router_w"], top_k, norm)
    j_out, j_aux = j_moe.moe_mlp(jx, jp, top_k, norm)
    j_grads = jax.grad(j_loss, argnums=(0, 1))(jx, jp)

    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    t_router = t_moe.moe_router(tx, tp["router_w"], top_k, norm)
    t_out, t_aux = t_moe.moe_mlp(tx, tp, top_k, norm)
    (torch.sum(t_out * torch.as_tensor(cot)) + aux_w * t_aux).backward()
    return (j_router, j_out, j_aux, j_grads), (t_router, t_out, t_aux, (tx.grad, tp))


@pytest.mark.parametrize("top_k", [1, 2, E])
@pytest.mark.parametrize("norm", [True, False])
def test_moe_router_and_mlp_match_jax(top_k, norm):
    cot = np.random.default_rng(99).normal(size=(T, H))
    x, p = _inputs(top_k + 10 * norm)
    (jr, jo, ja, _), (tr, to, ta, _) = _both(x, p, top_k, norm, cot.astype(np.float32))
    for got, want in zip(tr, jr):          # weights, probs, aux
        _close(got, want)
    assert int((tr[0] > 0).sum(-1).min()) == top_k
    _close(to, jo)
    _close(ta, ja)
    x, p = _inputs(top_k + 10 * norm, np.float64)
    *_, (jgx, jgp) = _both(x, p, top_k, norm, cot)[0]
    *_, (tgx, tgp) = _both(x, p, top_k, norm, cot)[1]
    _close(tgx, jgx)
    for k in p:
        _close(tgp[k].grad, jgp[k], atol=ROUTER_GRAD_ATOL if k == "router_w" else 1e-6)


def test_router_ties_rank_the_lower_expert_first():
    """Columns 1 and 4 of the router are equal and every product is exact
    in float32, so the two experts' probabilities tie exactly on every
    token; lax.top_k keeps expert 1 wherever only one of the two fits, and
    so must the port (as its weights, probs and gradients show)."""
    rng = np.random.default_rng(5)
    x = (rng.integers(-2, 3, size=(T, H)) * 0.5).astype(np.float32)
    w = (rng.integers(-4, 5, size=(H, E)) * 0.125).astype(np.float32)
    w[:, 4] = w[:, 1]
    _, p = _inputs(5)
    p["router_w"] = w
    cot = rng.normal(size=(T, H)).astype(np.float32)
    split = 0
    for top_k, norm in ((1, True), (2, False), (3, True)):
        (jr, jo, _, (_, jgp)), (tr, to, _, (_, tgp)) = _both(x, p, top_k, norm, cot)
        j_w, t_w = np.asarray(jr[0]), tr[0].detach().numpy()
        assert np.array_equal(np.asarray(jr[1])[:, 1], np.asarray(jr[1])[:, 4])
        one = (j_w[:, 1] > 0) != (j_w[:, 4] > 0)
        assert not (j_w[one, 4] > 0).any()        # JAX's rule, pinned
        split += int(one.sum())
        assert np.array_equal((t_w > 0), (j_w > 0))
        _close(tr[0], jr[0])
        _close(to, jo)
        _close(tgp["router_w"].grad, jgp["router_w"], atol=ROUTER_GRAD_ATOL)
    assert split >= 3, split          # the tie fell on the top-k boundary


def test_init_moe_params_shapes_and_spread():
    gen = torch.Generator().manual_seed(0)
    p = t_moe.init_moe_params(gen, 32, 16, 4, dtype=torch.bfloat16)
    j = jax.eval_shape(lambda k: j_moe.init_moe_params(k, 32, 16, 4, dtype=jnp.bfloat16),
                       jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in j.items()}
    for v in p.values():
        assert v.dtype == torch.bfloat16 and abs(v.float().std().item() - 0.02) < 0.004
