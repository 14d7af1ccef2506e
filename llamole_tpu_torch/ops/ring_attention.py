"""Ring attention: causal attention with the sequence sharded over the
mesh's sp axis (counterpart of llamole_tpu/ops/ring_attention.py).

Multi-controller: each rank of the sp group passes its own sequence
shard q / k / v [B, S/sp, H, D] and key mask [B, S/sp] (rank r holds
positions [r S/sp, (r+1) S/sp)) and gets its shard of the output. Its
k / v blocks go round the ring point to point (parallel/comm.py
ring_exchange) while it accumulates its queries' attention with the
online softmax of JAX's `_block_attend`, in f32 on global positions:
sp - 1 rotating steps, then the last block without a rotation, then
o / max(l, 1e-30) in q's dtype. The whole [S, S] score matrix never
exists on a rank.

The backward is the ring again (`_Ring`, a torch.autograd.Function;
point-to-point sends carry no gradient): each rank keeps its output and
the log-sum-exp of its rows, recomputes each visiting block's
probabilities, adds its queries' share of the block's dk / dv to
accumulators that travel with the block, and after the last block sends
them one step on, which brings each block's dk / dv home to its owner.

The block products are torch einsums: JAX computes them as XLA einsums,
not in a Pallas kernel.
"""

import math
from typing import Optional

import torch
import torch.distributed as dist

_NEG = -1e30


def _ring(group):
    """(ring size, this rank's place on it)."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _logits(q, k, scale, q_pos, k_pos, key_valid):
    """Masked f32 logits [B, H, Sq, Sk] of q [B, H, Sq, D] against k
    [B, H, Sk, D] and the mask: causal on global positions and key
    validity [B, Sk]."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = ((q_pos[:, None] >= k_pos[None, :])[None, None]
            & (key_valid > 0)[:, None, None, :])
    return torch.where(mask, logits, _NEG), mask


def _block_attend(q, k, v, scale, q_pos, k_pos, key_valid):
    """JAX _block_attend: the online-softmax partial attention of the
    local queries against one k / v block -> (m [B,H,Sq,1], l [B,H,Sq,1],
    o [B,H,Sq,D]), f32."""
    logits, mask = _logits(q, k, scale, q_pos, k_pos, key_valid)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return m, l, o


def _positions(block: int, s_local: int, device) -> torch.Tensor:
    return block * s_local + torch.arange(s_local, device=device)


def _rotate(tensors, group, n: int):
    if n == 1:
        return list(tensors)
    from ..parallel.comm import ring_exchange
    return ring_exchange(tensors, group)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, group):
        # [B, S, H, D] -> [B, H, S, D]
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        n, idx = _ring(group)
        b, h, s, d = qh.shape
        scale = 1.0 / math.sqrt(d)
        q_pos = _positions(idx, s, q.device)
        m = torch.full((b, h, s, 1), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
        k_c, v_c, mask_c = kh.contiguous(), vh.contiguous(), key_valid
        for t in range(n):
            src = (idx - t) % n      # whose k / v block this rank holds
            bm, bl, bo = _block_attend(qh, k_c, v_c, scale, q_pos,
                                       _positions(src, s, q.device), mask_c)
            new_m = torch.maximum(m, bm)
            alpha, beta = torch.exp(m - new_m), torch.exp(bm - new_m)
            m, l, o = new_m, l * alpha + bl * beta, o * alpha + bo * beta
            if t < n - 1:            # the last block is not rotated on
                k_c, v_c, mask_c = _rotate((k_c, v_c, mask_c), group, n)
        out = o / l.clamp_min(1e-30)
        ctx.save_for_backward(qh, kh, vh, key_valid, out, m, l)
        ctx.group, ctx.scale = group, scale
        return out.to(q.dtype).transpose(1, 2)

    @staticmethod
    def backward(ctx, grad):
        qh, kh, vh, key_valid, out, m, l = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n, idx = _ring(group)
        s = qh.shape[2]
        g = grad.transpose(1, 2).float()                       # [B,H,S,D]
        # the rows' log-sum-exp; a row that attends no key keeps -inf
        lse = m + torch.log(l)
        delta = (g * out).sum(dim=-1, keepdim=True)
        q_pos = _positions(idx, s, qh.device)
        dq = torch.zeros_like(g)
        k_c, v_c, mask_c = kh.contiguous(), vh.contiguous(), key_valid
        dk = torch.zeros(kh.shape, dtype=torch.float32, device=kh.device)
        dv = torch.zeros_like(dk)
        for t in range(n):
            src = (idx - t) % n
            logits, mask = _logits(qh, k_c, scale, q_pos,
                                   _positions(src, s, qh.device), mask_c)
            p = torch.where(mask, torch.exp(logits - lse), 0.0)
            dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, g)
            dp = torch.einsum("bhqd,bhkd->bhqk", g, v_c.float())
            ds = torch.where(mask, p * (dp - delta), 0.0) * scale
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, k_c.float())
            dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, qh.float())
            if t < n - 1:
                k_c, v_c, mask_c, dk, dv = _rotate(
                    (k_c, v_c, mask_c, dk, dv), group, n)
        # the accumulators hold block idx + 1's gradient: one step on
        # brings it to its owner
        dk, dv = _rotate((dk, dv), group, n)

        def back(t, like):
            return t.to(like.dtype).transpose(1, 2)
        return back(dq, qh), back(dk, kh), back(dv, vh), None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   attention_mask: Optional[torch.Tensor],
                   group=None) -> torch.Tensor:
    """Causal multi-head attention over a sequence sharded on the ranks
    of `group` (the sp axis's process group; None: one rank, the whole
    sequence here). q / k / v [B, S/sp, H, D] this rank's shard,
    attention_mask [B, S/sp] (1 = a real token; None: all real) ->
    [B, S/sp, H, D] in q's dtype, differentiable in q, k and v. Every
    rank of the group calls it with shards of one shape."""
    b, s, _, _ = q.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32,
                                    device=q.device)
    # an integer mask: gloo sends no bool tensors
    return _Ring.apply(q, k, v, (attention_mask > 0).to(torch.int32), group)
