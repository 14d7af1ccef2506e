"""The arithmetic of kernel E's head_dim-256 backward, emulated on the CPU
and held to jaxlib's backward kernels in TPU interpret mode.

`flash_bwd_dq_wide_kernel` and `flash_bwd_dkv_wide_kernel`
(llamole_tpu_torch/csrc/flash_attention.cu) run only on the card.
`emulate_backward` repeats their arithmetic in torch:

- delta = rowsum(dO * O), four threads a row of 64 dims each, added
  pairwise (the dq kernel forms it and writes it for dkv);
- dq: blocks of 64 query rows, 64-key steps up to the block's diagonal,
  warpgroup w taking keys 32 w..32 w + 31 of each step for all 64 rows
  with its own f32 partial dQ, each partial kept as two 128-wide halves
  of D; the two partials added once at the end;
- dkv: one block per (b, query head, 64 keys), 64-query steps from the
  block's first key to S; P^T from S^T = K.Q^T, dS^T from dP^T = V.dO^T
  and P; dV += P^T.dO and dK += dS^T.Q over two 128-wide halves of D;
  with G = H / KV > 1 each head's f32 partials summed over the group in
  head order (flash_group_sum_kernel), with G = 1 written directly;
- P = 2^(s * scale * log2 e - lse * log2 e) (the kernels' fmaf and
  ex2.approx; in f64 here, one rounding as the fmaf), 0 on a masked pair
  (j > i or another segment); dS = P (dP - delta) scale, cast to q's
  dtype after the scale (jaxlib casts ds to k's type); P cast to dO's
  dtype for dV.

In f32 its dq / dk / dv are held within 2e-5 and delta within 1e-5 of
jaxlib's `_flash_attention_bwd_dq` / `_flash_attention_bwd_dkv` (and the
`di` that `_flash_attention_bwd` forms), on the residuals of jaxlib's
`_flash_attention_impl`, at padded shapes: G = 1 and G = 2, padded both
sides, a split segment, one with more than 64 right-padded rows. Planted
mutants (a skipped query step, a dropped half of D, the group's heads in
the wrong order) fail the same limits. Each interpret-mode call runs as
one jitted computation: eager JAX operations dispatched beside its host
callbacks can deadlock the CPU client.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    DEFAULT_MASK_VALUE, SegmentIds, _flash_attention_bwd_dkv,
    _flash_attention_bwd_dq, _flash_attention_impl)

GRAD_ATOL = 2e-5
DELTA_ATOL = 1e-5
ROWS = 64           # query rows of a dq block, keys of a dkv block, a step
WG_KEYS = 32        # keys of a dq step a warpgroup takes
HALF = 128          # the width of one product's half of D
LOG2E = 1.4426950408889634
BLOCK = 128         # jaxlib's default block sizes (BlockSizes.get_default)
MUTANTS = ("skip_query_step", "drop_d_half", "wrong_head_order")

# (b, s, h, kv, d), then per row (left pad, start of a second segment or
# None, right pad): segment 0 pads, 1 the text, 2 a packed second sequence
CASES = {
    "1x256x2x2x256": ((1, 256, 2, 2, 256), ((9, None, 13),)),
    "2x256x4x2x256": ((2, 256, 4, 2, 256), ((9, 100, 0), (0, None, 100))),
    "1x384x2x1x256": ((1, 384, 2, 1, 256), ((7, 150, 140),)),
}


def _segments(s, rows):
    seg = np.ones((len(rows), s), np.int32)
    for r, (left, split, right) in enumerate(rows):
        if split is not None:
            seg[r, split:] = 2
        seg[r, :left] = 0
        seg[r, s - right:] = 0
    return seg


def _probs(s, lse, allowed, scale):
    """P = 2^(s scale log2 e - lse log2 e) where allowed, else 0."""
    scale2 = scale * LOG2E
    p = torch.exp2((s.double() * scale2 - (lse * LOG2E).double()).float())
    return torch.where(allowed, p, torch.zeros(()))


def emulate_delta(out, dout):
    """rowsum(dO * O) [B, H, S] in f32: four partial sums of 64 dims a row,
    added as (x0 + x1) + (x2 + x3)."""
    b, s, h, d = out.shape
    part = (out.float() * dout.float()).reshape(b, s, h, 4, d // 4).sum(-1)
    total = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    return total.permute(0, 2, 1)


def emulate_backward(q, k, v, seg, out, dout, lse, mutant=None):
    """The head_dim-256 backward kernels' arithmetic: q, out, dout [B, S,
    H, D], k / v [B, S, KV, D], seg [B, S], lse [B, H, S] (natural log) ->
    (dq, dk, dv in q's dtype, delta [B, H, S] f32). `mutant` plants one of
    MUTANTS."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    delta = emulate_delta(out, dout)
    pos = torch.arange(s)
    qf, dof = q.float(), dout.float()
    # query head h reads KV head h // g
    kh = torch.repeat_interleave(k.float(), g, dim=2)
    vh = torch.repeat_interleave(v.float(), g, dim=2)
    dq = torch.empty(b, s, h, d)
    for bi in range(b):
        sg = seg[bi]
        for q0 in range(0, s, ROWS):
            rows = slice(q0, q0 + ROWS)
            lse_r = lse[bi, :, rows][:, :, None]                  # [H, 64, 1]
            delta_r = delta[bi, :, rows][:, :, None]
            parts = [torch.zeros(h, ROWS, d) for _ in range(2)]
            for j0 in range(0, q0 + ROWS, ROWS):
                for w in range(2):
                    keys = slice(j0 + WG_KEYS * w, j0 + WG_KEYS * (w + 1))
                    sc = torch.einsum("rhd,khd->hrk", qf[bi, rows],
                                      kh[bi, keys])
                    dp = torch.einsum("rhd,khd->hrk", dof[bi, rows],
                                      vh[bi, keys])
                    allowed = ((pos[keys][None, :] <= pos[rows][:, None])
                               & (sg[keys][None, :] == sg[rows][:, None]))
                    p = _probs(sc, lse_r, allowed, scale)
                    ds = (p * (dp - delta_r) * scale).to(q.dtype).float()
                    for half in range(d // HALF):
                        dims = slice(half * HALF, (half + 1) * HALF)
                        parts[w][..., dims] += torch.einsum(
                            "hrk,khd->hrd", ds, kh[bi, keys, :, dims])
            total = parts[0] + parts[1]
            if mutant == "drop_d_half":   # the exchange leaves out a half
                total[..., HALF:] = parts[1][..., HALF:]
            dq[bi, rows] = total.transpose(0, 1)
    dk_h = torch.empty(b, s, h, d)
    dv_h = torch.empty(b, s, h, d)
    for bi in range(b):
        sg = seg[bi]
        for j0 in range(0, s, ROWS):
            keys = slice(j0, j0 + ROWS)
            acc_k = torch.zeros(h, ROWS, d)
            acc_v = torch.zeros(h, ROWS, d)
            for it, i0 in enumerate(range(j0, s, ROWS)):
                if mutant == "skip_query_step" and it == 1:
                    continue
                qs = slice(i0, i0 + ROWS)
                st = torch.einsum("khd,qhd->hkq", kh[bi, keys], qf[bi, qs])
                dpt = torch.einsum("khd,qhd->hkq", vh[bi, keys], dof[bi, qs])
                allowed = ((pos[keys][:, None] <= pos[qs][None, :])
                           & (sg[keys][:, None] == sg[qs][None, :]))
                p = _probs(st, lse[bi, :, qs][:, None, :], allowed, scale)
                dst = (p * (dpt - delta[bi, :, qs][:, None, :]) * scale).to(
                    q.dtype).float()
                pv = p.to(dout.dtype).float()
                for half in range(d // HALF):
                    dims = slice(half * HALF, (half + 1) * HALF)
                    acc_v[..., dims] += torch.einsum("hkq,qhd->hkd", pv,
                                                     dof[bi, qs, :, dims])
                    acc_k[..., dims] += torch.einsum("hkq,qhd->hkd", dst,
                                                     qf[bi, qs, :, dims])
            dk_h[bi, keys] = acc_k.transpose(0, 1)
            dv_h[bi, keys] = acc_v.transpose(0, 1)
    # the group sum, head order within each KV head's group
    order = [[kvh * g + gi for gi in range(g)] for kvh in range(kv)]
    if mutant == "wrong_head_order":
        order = [[kvh + kv * gi for gi in range(g)] for kvh in range(kv)]
    dk = torch.empty(b, s, kv, d)
    dv = torch.empty(b, s, kv, d)
    for kvh, heads in enumerate(order):
        sk, sv = dk_h[:, :, heads[0]].clone(), dv_h[:, :, heads[0]].clone()
        for hh in heads[1:]:
            sk += dk_h[:, :, hh]
            sv += dv_h[:, :, hh]
        dk[:, :, kvh], dv[:, :, kvh] = sk, sv
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), delta)


def _interpret(fn, *args):
    """fn(*args) as one jitted computation, waited for."""
    return jax.block_until_ready(jax.jit(fn)(*args))


def _jax_backward(q, k, v, seg, dout):
    """jaxlib's forward residuals and backward kernels in interpret mode,
    as `_flash_attention_bwd` calls them: (out [B, S, H, D], lse [B, H,
    S], dq [B, S, H, D], dk / dv [B, S, KV, D] summed over each group as
    the JAX route's repeat of k and v sums them, di [B, H, S])."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    sm_scale = 1.0 / np.sqrt(d)

    def run(q, k, v, seg, dout):
        to_heads = lambda t: jnp.moveaxis(jnp.repeat(t, g, axis=2), 2, 1)
        qt, kt, vt = jnp.moveaxis(q, 2, 1), to_heads(k), to_heads(v)
        dot = jnp.moveaxis(dout, 2, 1)
        ids = SegmentIds(q=seg, kv=seg)
        o, l, m = _flash_attention_impl(qt, kt, vt, None, ids, True, True,
                                        sm_scale, 1, BLOCK, BLOCK, BLOCK,
                                        False)
        di = jnp.sum(o.astype(jnp.float32) * dot.astype(jnp.float32), -1)
        dk, dv = _flash_attention_bwd_dkv(
            qt, kt, vt, None, ids, l, m, dot, di, block_q_major=BLOCK,
            block_q=BLOCK, block_k_major=BLOCK, block_k=BLOCK,
            sm_scale=sm_scale, causal=True, mask_value=DEFAULT_MASK_VALUE,
            debug=False)
        dq, _ = _flash_attention_bwd_dq(
            qt, kt, vt, None, ids, l, m, dot, di, block_q_major=BLOCK,
            block_k_major=BLOCK, block_k=BLOCK, sm_scale=sm_scale,
            causal=True, mask_value=DEFAULT_MASK_VALUE, debug=False)
        group = lambda t: jnp.moveaxis(t, 1, 2).reshape(b, s, kv, g, d).sum(3)
        return (jnp.moveaxis(o, 1, 2), m + jnp.log(l), jnp.moveaxis(dq, 1, 2),
                group(dk), group(dv), di)

    with pltpu.force_tpu_interpret_mode():
        got = _interpret(run, *(jnp.asarray(a) for a in (q, k, v, seg, dout)))
    return tuple(np.asarray(x) for x in got)


@functools.lru_cache(maxsize=None)
def _case(name):
    """A case's seeded inputs and jaxlib's results (computed once)."""
    shape, rows = CASES[name]
    b, s, h, kv, d = shape
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    dout = rng.normal(size=(b, s, h, d)).astype(np.float32)
    seg = _segments(s, rows)
    return (q, k, v, seg, dout), _jax_backward(q, k, v, seg, dout)


def _emulated(name, mutant=None):
    (q, k, v, seg, dout), (out, lse, *_) = _case(name)
    t = lambda a: torch.from_numpy(np.array(a))
    return emulate_backward(t(q), t(k), t(v), t(seg), t(out), t(dout),
                            t(lse), mutant)


def _gaps(name, mutant=None):
    """max |emulated - jaxlib| of dq, dk, dv and delta."""
    got = _emulated(name, mutant)
    want = _case(name)[1][2:]
    return [float(np.abs(a.numpy() - w).max()) for a, w in zip(got, want)]


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_backward_matches_jax_interpret_kernels(case):
    """The emulated head_dim-256 backward against jaxlib's dq and dkv
    kernels in f32: dq / dk / dv within 2e-5, delta within 1e-5, pad rows
    included."""
    dq, dk, dv, delta = _gaps(case)
    assert max(dq, dk, dv) <= GRAD_ATOL, (dq, dk, dv)
    assert delta <= DELTA_ATOL, delta


def test_the_cases_cover_the_grid_edges():
    """G = 1 and G = 2 among the cases; every case padded on both sides
    of some row; one right-padded by more than a 64-row step; and the
    dq steps split between warpgroups cross a segment boundary."""
    groups = {shape[2] // shape[3] for shape, _ in CASES.values()}
    assert groups == {1, 2}
    rights = [r[2] for _, rows in CASES.values() for r in rows]
    assert max(rights) > ROWS
    for shape, rows in CASES.values():
        assert any(r[0] for r in rows) and any(r[2] for r in rows)
        assert shape[1] % BLOCK == 0 and shape[4] == 256
    assert any(r[1] is not None and r[1] % WG_KEYS for _, rows in
               CASES.values() for r in rows)


@pytest.mark.parametrize("mutant", MUTANTS)
def test_planted_mutants_fail(mutant):
    """Each planted fault moves dq, dk or dv past 2e-5 of jaxlib's on the
    G = 2 case with two KV heads: a dkv query step skipped, dQ's second
    half of D left without the other warpgroup's partial, the group sum
    over the wrong heads (kv + KV i in place of kv G + i)."""
    assert max(_gaps("2x256x4x2x256", mutant)[:3]) > GRAD_ATOL


def test_the_wrapper_routes_head_dim_256_to_the_wide_bodies():
    """backward_body names the bodies csrc/flash_attention.cu routes to
    ("wgmma" at D = 128, "wgmma_wide" at 256 in bf16, "tf32x3" in f32),
    and dkv_workspace gives both head dims with G > 1 the f32 workspace
    [2, G, B, S, KV, D] that the group sum reads (None with G = 1), in
    bf16 and f32 alike."""
    from llamole_tpu_torch.ops import flash_attention as E
    bf16, f32 = torch.bfloat16, torch.float32
    assert [E.backward_body(bf16, d) for d in (128, 256)] == ["wgmma",
                                                              "wgmma_wide"]
    assert {E.backward_body(f32, d) for d in (128, 256)} == {"tf32x3"}
    with pytest.raises(ValueError, match="head_dim"):
        E.backward_body(bf16, 64)
    for d in (128, 256):
        work = E.dkv_workspace(1, 256, 4, 2, d, "cpu")
        assert work.shape == (2, 2, 1, 256, 2, d) and work.dtype == f32
        assert E.dkv_workspace(1, 256, 4, 4, d, "cpu") is None
