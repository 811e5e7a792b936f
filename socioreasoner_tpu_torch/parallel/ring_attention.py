"""Ring attention over the "sp" devices, the counterpart of
socioreasoner_tpu/parallel/ring_attention.py.

The sequence is split over the sp devices; at each step every device
computes the partial attention of its local queries against the K/V block
it holds and folds it into an f32 online softmax, then the K/V blocks move
one device along the ring. The JAX package runs this as a shard_map body
with `jax.lax.ppermute`; the port runs it as one controller over the
devices' shards: rotating a block is `.to()` onto the next device, which
autograd carries back in the backward. The arithmetic is plain PyTorch, as
it is plain `jnp` in the JAX package (no Pallas kernel is reached).

`*_local` take the per-device shards (lists, one (B, L/n, H, D) tensor a
device, each on its device); `*_sharded` / `ring_attention_zigzag` take
global (B, L, H, D) tensors and a Mesh (its `seq_axis` devices) or a plain
device list, and return the global result on q's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .mesh import tp_devices

NEG_INF = -1e30


def _block_attend(q, k, v, scale, q_offset, k_offset, causal):
    """Partial attention of local q against one K/V block: (m, l, o), the
    row maxima and sums (B, H, Lq) in f32 and the unnormalised output in
    v's dtype."""
    Lq, Lk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(Lq, device=q.device)
        k_pos = k_offset + torch.arange(Lk, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        logits = torch.where(mask[None, None], logits, NEG_INF)
    m = logits.amax(dim=-1)                                    # (B, H, Lq)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return m, l, o


def _rotate(blocks: List[tuple], devices: Sequence[torch.device]) -> List[tuple]:
    """Each device's block (a tuple of tensors) moved to the next device of
    the ring: device r receives device r-1's."""
    n = len(blocks)
    return [tuple(t.to(devices[r]) for t in blocks[(r - 1) % n]) for r in range(n)]


def _finish(o: torch.Tensor, l: torch.Tensor, dtype) -> torch.Tensor:
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (o / l.transpose(1, 2)[..., None]).to(dtype)


def ring_attention_local(qs: List[torch.Tensor], ks: List[torch.Tensor],
                         vs: List[torch.Tensor], causal: bool = True) -> List[torch.Tensor]:
    """The contiguous ring: device r holds queries r * L/n .. of the
    sequence and, at step i, the K/V block of device (r - i) mod n."""
    n = len(qs)
    B, Lq, H, D = qs[0].shape
    scale = D ** -0.5
    devices = [q.device for q in qs]
    state = [(torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=dev),
              torch.zeros((B, H, Lq), dtype=torch.float32, device=dev),
              torch.zeros((B, Lq, H, D), dtype=torch.float32, device=dev))
             for dev in devices]
    blocks = list(zip(ks, vs))
    for i in range(n):
        for r in range(n):
            k_blk, v_blk = blocks[r]
            src = (r - i) % n          # which shard's K/V device r holds this step
            m_blk, l_blk, o_blk = _block_attend(qs[r], k_blk, v_blk, scale,
                                                r * Lq, src * Lq, causal)
            m_run, l_run, o_run = state[r]
            m_new = torch.maximum(m_run, m_blk)
            c_run = torch.exp(m_run - m_new)
            c_blk = torch.exp(m_blk - m_new)
            l_new = l_run * c_run + l_blk * c_blk
            # o accumulators are (B, Lq, H, D); correction factors (B, H, Lq)
            o_new = (o_run * c_run.transpose(1, 2)[..., None].to(o_run.dtype)
                     + o_blk * c_blk.transpose(1, 2)[..., None].to(o_blk.dtype))
            state[r] = (m_new, l_new, o_new)
        if i < n - 1:
            blocks = _rotate(blocks, devices)
    return [_finish(o, l, q.dtype) for (_, l, o), q in zip(state, qs)]


def _split(x: torch.Tensor, devices: Sequence[torch.device], dim: int = 1) -> List[torch.Tensor]:
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"sequence length {x.shape[dim]} does not split over {n} devices")
    return [part.to(dev) for part, dev in zip(x.chunk(n, dim=dim), devices)]


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh, seq_axis: str = "sp", causal: bool = True) -> torch.Tensor:
    """(B, L, H, D) global tensors, L split over the `seq_axis` devices."""
    devices = tp_devices(mesh, seq_axis)
    outs = ring_attention_local(_split(q, devices), _split(k, devices), _split(v, devices),
                                causal)
    return torch.cat([o.to(q.device) for o in outs], dim=1)


# --------------------------------------------------------------------- zigzag
# Position-aware variant: causality is decided by GLOBAL token positions that
# travel around the ring with K/V, so any sequence permutation -- in
# particular the zigzag 2-chunk layout, which balances causal work across
# ranks -- is handled exactly. The local block attend is blockwise over K
# sub-chunks: logits exist only (B, H, Lq, k_chunk) at a time.

def _pick_chunk(Lk: int, k_chunk: int) -> int:
    kc = min(k_chunk, Lk)
    while Lk % kc:
        kc -= 1
    return kc


def ring_attention_pos_local(qs: List[torch.Tensor], ks: List[torch.Tensor],
                             vs: List[torch.Tensor], q_pos: List[torch.Tensor],
                             kv_pos: List[torch.Tensor], kv_mask: List[torch.Tensor], *,
                             causal: bool = True, k_chunk: int = 512) -> List[torch.Tensor]:
    """Per-device shards, one entry a device of the ring:
      qs, ks, vs   (B, Lloc, H, D)  -- the same head count (GQA repeated)
      q_pos        (B, Lloc) int    -- global positions of the local queries
      kv_pos       (B, Lloc) int    -- global positions of the local keys
      kv_mask      (B, Lloc) 1=valid -- the padding mask, rotating with K/V
    """
    n = len(qs)
    B, Lq, H, D = qs[0].shape
    scale = D ** -0.5
    devices = [q.device for q in qs]
    qf = [q.float() * scale for q in qs]
    Lk = ks[0].shape[1]
    kc = _pick_chunk(Lk, k_chunk)
    state = [(torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=dev),
              torch.zeros((B, H, Lq), dtype=torch.float32, device=dev),
              torch.zeros((B, Lq, H, D), dtype=torch.float32, device=dev))
             for dev in devices]
    blocks = list(zip(ks, vs, kv_pos, kv_mask))
    for step in range(n):
        for r in range(n):
            k_blk, v_blk, pos_blk, mask_blk = blocks[r]
            m_run, l_run, o_run = state[r]
            for c in range(0, Lk, kc):
                k_c, v_c = k_blk[:, c:c + kc], v_blk[:, c:c + kc]
                pos_c, mask_c = pos_blk[:, c:c + kc], mask_blk[:, c:c + kc]
                logits = torch.einsum("bqhd,bkhd->bhqk", qf[r], k_c.float())
                keep = mask_c[:, None, None, :] != 0
                if causal:
                    keep = keep & (pos_c[:, None, None, :] <= q_pos[r][:, None, :, None])
                logits = torch.where(keep, logits, NEG_INF)
                m_blk = logits.amax(dim=-1)                       # (B, H, Lq)
                m_new = torch.maximum(m_run, m_blk)
                # fully-masked block: keep exp at 0, not exp(NEG_INF-NEG_INF)=1
                p = torch.where(logits > NEG_INF / 2,
                                torch.exp(logits - m_new[..., None]), 0.0)
                c_run = torch.exp(m_run - m_new)
                l_run = l_run * c_run + p.sum(dim=-1)
                o_blk = torch.einsum("bhqk,bkhd->bqhd", p, v_c.float())
                o_run = o_run * c_run.transpose(1, 2)[..., None] + o_blk
                m_run = m_new
            state[r] = (m_run, l_run, o_run)
        if step < n - 1:
            blocks = _rotate(blocks, devices)
    return [_finish(o, l, q.dtype) for (_, l, o), q in zip(state, qs)]


def ring_attention_zigzag(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          positions: torch.Tensor, attention_mask: Optional[torch.Tensor],
                          mesh, seq_axis: str = "sp", causal: bool = True,
                          k_chunk: int = 512) -> torch.Tensor:
    """Global (B, L, H, D) tensors in any (e.g. zigzag) sequence layout, L
    split over the `seq_axis` devices; `positions` (B, L) (or (L,))
    carries the global position of every token for exact causal masking.
    GQA K/V are repeated to the query head count here."""
    B, L, H, D = q.shape
    if k.shape[2] != H:                       # GQA: repeat KV heads
        rep = H // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if attention_mask is None:
        attention_mask = torch.ones((B, L), dtype=torch.int32, device=q.device)
    positions = torch.broadcast_to(positions, (B, L))
    devices = tp_devices(mesh, seq_axis)
    pos = _split(positions, devices)
    outs = ring_attention_pos_local(
        _split(q, devices), _split(k, devices), _split(v, devices), pos, pos,
        _split(attention_mask, devices), causal=causal, k_chunk=k_chunk)
    return torch.cat([o.to(q.device) for o in outs], dim=1)
