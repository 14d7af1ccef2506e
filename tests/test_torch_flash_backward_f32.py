"""The arithmetic of kernel E's f32 backward, emulated on the CPU and held
to jaxlib's backward kernels in TPU interpret mode.

`flash_bwd_dq_tf32_kernel<D>` and `flash_bwd_dkv_tf32_kernel<D>`
(llamole_tpu_torch/csrc/flash_attention.cu) run only on the card.
`emulate_backward` repeats their arithmetic in torch:

- every product in split TF32: each operand split into hi = TF32(x) and
  lo = TF32(x - hi) (TF32 rounding to nearest, ties away from zero, as
  `cvt.rna.tf32.f32` rounds: test_torch_attention_tf32x3's `split`), the
  product the f32 sum lo.hi + hi.lo + hi.hi (each part exact in f32);
- delta = rowsum(dO * O), DELTA_PARTS[D] threads a row of D / parts dims
  each, the parts added pairwise (the dq kernel forms it and writes it
  for dkv);
- dq: blocks of DQ_ROWS[D] query rows, steps of DQ_KEYS[D] keys up to the
  block's diagonal; S = Q.K^T and dP = dO.V^T (at D = 256 the sum of two
  warps' products over one half of D each), P, dS, dQ += dS.K;
- dkv: one block per (b, query head, 64 keys), steps of DKV_QUERIES[D]
  queries from the block's first key to S; S^T = K.Q^T, P^T, dP^T = V.dO^T,
  dS^T, dV += P^T.dO and dK += dS^T.Q; with G = H / KV > 1 each head's f32
  partials summed over the group in head order (flash_group_sum_kernel),
  with G = 1 written directly;
- P = 2^(s * scale * log2 e - lse * log2 e) (the kernels' fmaf and
  ex2.approx; in f64 here, one rounding as the fmaf), 0 on a masked pair
  (j > i or another segment); dS = P (dP - delta) scale. The steps a warp
  skips (wholly above the diagonal, or no pair of the step in its rows'
  one segment) add 0 and are not emulated.

In f32 its dq / dk / dv and delta are held within 1e-4 (the f32 limit
chip_smoke.py holds the kernels to) of jaxlib's `_flash_attention_bwd_dq`
/ `_flash_attention_bwd_dkv` (and the `di` that `_flash_attention_bwd`
forms), on the residuals of jaxlib's `_flash_attention_impl`, at padded
shapes: both head dims, G = 1 and G = 2, padded on both sides, a split
segment. Planted mutants (the lo.hi pass dropped, a dq key step skipped,
dkv on the wrong KV head) fail the same limit. Each interpret-mode call
runs as one jitted computation (the helpers of
test_torch_flash_backward_d256): eager JAX operations dispatched beside
its host callbacks can deadlock the CPU client.
"""

import functools
import math

import numpy as np
import pytest
import torch

from llamole_tpu_torch.ops import flash_attention as E
from llamole_tpu_torch.ops.cuda_lib import MAX_SHARED_BYTES
from test_torch_attention_tf32x3 import split
from test_torch_flash_backward_d256 import _jax_backward, _probs, _segments

ATOL = 1e-4
# the tiles of csrc/flash_attention.cu's Tf32Dq<D> / Tf32Dkv<D>: query rows
# a dq block and keys a dq step; keys a dkv block and queries a dkv step
DQ_ROWS = {128: 128, 256: 64}
DQ_KEYS = {128: 32, 256: 16}
DQ_SPLIT = {128: 1, 256: 2}          # warps (parts of D) a dq row tile
DELTA_PARTS = {128: 2, 256: 4}       # dq threads a row of delta
DKV_KEYS = 64
DKV_QUERIES = {128: 64, 256: 16}
STAGES = 2
MUTANTS = ("drop_lo_hi", "skip_key_step", "wrong_kv_head")

# (b, s, h, kv, d), then per row (left pad, start of a second segment or
# None, right pad): segment 0 pads, 1 the text, 2 a packed second sequence
CASES = {
    "1x256x2x2x128": ((1, 256, 2, 2, 128), ((9, None, 13),)),
    "2x256x4x2x128": ((2, 256, 4, 2, 128), ((9, 100, 0), (0, None, 70))),
    "1x256x2x1x256": ((1, 256, 2, 1, 256), ((7, 150, 40),)),
    "1x256x2x2x256": ((1, 256, 2, 2, 256), ((0, None, 100),)),
}


def product(a, b, mutant=None):
    """a @ b (batched over leading dims) in split TF32: (lo.hi + hi.lo) +
    hi.hi in f32; the mutant "drop_lo_hi" leaves out lo.hi."""
    ah, al = split(a.contiguous())
    bh, bl = split(b.contiguous())
    small = ah @ bl if mutant == "drop_lo_hi" else al @ bh + ah @ bl
    return small + ah @ bh


def emulate_delta(out, dout):
    """rowsum(dO * O) [B, H, S]: DELTA_PARTS[D] partial sums a row, added
    pairwise ((p0 + p1) + (p2 + p3) for four)."""
    b, s, h, d = out.shape
    n = DELTA_PARTS[d]
    part = (out * dout).reshape(b, s, h, n, d // n).sum(-1)
    while part.shape[-1] > 1:
        part = part[..., 0::2] + part[..., 1::2]
    return part[..., 0].permute(0, 2, 1)


def _allowed(seg, rows, cols):
    """[len(rows), len(cols)]: query rows[i] attends key cols[j]."""
    pos = torch.arange(seg.shape[0])
    return ((pos[cols][None, :] <= pos[rows][:, None])
            & (seg[cols][None, :] == seg[rows][:, None]))


def emulate_backward(q, k, v, seg, out, dout, lse, mutant=None):
    """The f32 backward kernels' arithmetic: q, out, dout [B, S, H, D], k / v
    [B, S, KV, D], seg [B, S], lse [B, H, S] (natural log) -> (dq, dk, dv,
    delta [B, H, S]), all f32. `mutant` plants one of MUTANTS."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    delta = emulate_delta(out, dout)
    heads = torch.arange(h)
    mul = functools.partial(product, mutant=mutant)
    # query head h reads KV head h // g (the mutant: h % kv)
    kvh = heads % kv if mutant == "wrong_kv_head" else heads // g
    qh, doh = q.transpose(1, 2), dout.transpose(1, 2)       # [B, H, S, D]
    kh, vh = k.transpose(1, 2)[:, kvh], v.transpose(1, 2)[:, kvh]
    rows_a, keys_a = DQ_ROWS[d], DQ_KEYS[d]
    halves = [slice(i * d // DQ_SPLIT[d], (i + 1) * d // DQ_SPLIT[d])
              for i in range(DQ_SPLIT[d])]

    def split_d(a, b):
        """a @ b^T over D as the dq warps sum it: a part of D each."""
        return sum(mul(a[..., hd], b[..., hd].transpose(1, 2))
                   for hd in halves)

    dq = torch.empty(b, h, s, d)
    for bi in range(b):
        for q0 in range(0, s, rows_a):
            rows = slice(q0, q0 + rows_a)
            acc = torch.zeros(h, rows_a, d)
            for step, j0 in enumerate(range(0, q0 + rows_a, keys_a)):
                if mutant == "skip_key_step" and step == 1:
                    continue
                keys = slice(j0, j0 + keys_a)
                sc = split_d(qh[bi, :, rows], kh[bi, :, keys])
                dp = split_d(doh[bi, :, rows], vh[bi, :, keys])
                p = _probs(sc, lse[bi, :, rows][:, :, None],
                           _allowed(seg[bi], rows, keys), scale)
                ds = p * (dp - delta[bi, :, rows][:, :, None]) * scale
                acc += mul(ds, kh[bi, :, keys])
            dq[bi, :, rows] = acc
    steps = DKV_QUERIES[d]
    dk_h = torch.empty(b, h, s, d)
    dv_h = torch.empty(b, h, s, d)
    for bi in range(b):
        for j0 in range(0, s, DKV_KEYS):
            keys = slice(j0, j0 + DKV_KEYS)
            acc_k = torch.zeros(h, DKV_KEYS, d)
            acc_v = torch.zeros(h, DKV_KEYS, d)
            for i0 in range(j0, s, steps):
                qs = slice(i0, i0 + steps)
                st = mul(kh[bi, :, keys], qh[bi, :, qs].transpose(1, 2))
                dpt = mul(vh[bi, :, keys], doh[bi, :, qs].transpose(1, 2))
                pt = _probs(st, lse[bi, :, qs][:, None, :],
                            _allowed(seg[bi], qs, keys).T, scale)
                dst = pt * (dpt - delta[bi, :, qs][:, None, :]) * scale
                acc_v += mul(pt, doh[bi, :, qs])
                acc_k += mul(dst, qh[bi, :, qs])
            dk_h[bi, :, keys] = acc_k
            dv_h[bi, :, keys] = acc_v
    # the group sum in head order within each KV head's group
    dk = torch.empty(b, kv, s, d)
    dv = torch.empty(b, kv, s, d)
    for j in range(kv):
        sk, sv = dk_h[:, j * g].clone(), dv_h[:, j * g].clone()
        for hh in range(j * g + 1, (j + 1) * g):
            sk += dk_h[:, hh]
            sv += dv_h[:, hh]
        dk[:, j], dv[:, j] = sk, sv
    return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
            delta)


@functools.lru_cache(maxsize=None)
def _case(name):
    """A case's seeded inputs and jaxlib's results (computed once)."""
    shape, rows = CASES[name]
    b, s, h, kv, d = shape
    rng = np.random.default_rng(1)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    dout = rng.normal(size=(b, s, h, d)).astype(np.float32)
    seg = _segments(s, rows)
    return (q, k, v, seg, dout), _jax_backward(q, k, v, seg, dout)


def _gaps(name, mutant=None):
    """max |emulated - jaxlib| of dq, dk, dv and delta."""
    (q, k, v, seg, dout), (out, lse, *want) = _case(name)
    t = lambda a: torch.from_numpy(np.array(a))
    got = emulate_backward(t(q), t(k), t(v), t(seg), t(out), t(dout),
                           t(lse), mutant)
    return [float(np.abs(a.numpy() - w).max()) for a, w in zip(got, want)]


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_f32_backward_matches_jax_interpret_kernels(case):
    """The emulated split-TF32 backward against jaxlib's dq and dkv
    kernels in f32: dq / dk / dv and delta within 1e-4, pad rows
    included."""
    gaps = _gaps(case)
    assert max(gaps) <= ATOL, gaps


def test_the_cases_cover_both_head_dims_groups_and_pads():
    """Both head dims with G = 1 and G = 2 each; every case padded on the
    left or the right of some row, and both sides among the cases; one row
    right-padded past a dkv step and a dq block's key step."""
    cover = {(shape[4], shape[2] // shape[3]) for shape, _ in CASES.values()}
    assert cover == {(128, 1), (128, 2), (256, 1), (256, 2)}
    rows = [r for _, rs in CASES.values() for r in rs]
    assert any(r[0] for r in rows) and any(r[2] for r in rows)
    assert max(r[2] for r in rows) > max(DKV_QUERIES.values())
    for shape, _ in CASES.values():
        assert shape[1] % E.SEQ_MULTIPLE == 0


@pytest.mark.parametrize("mutant", MUTANTS)
def test_planted_mutants_fail(mutant):
    """Each planted fault moves dq, dk or dv past 1e-4 of jaxlib's on the
    G = 2 case with two KV heads: the lo.hi pass of every product dropped,
    dq's second key step skipped, dkv reading KV head h % KV in place of
    h // G."""
    assert max(_gaps("2x256x4x2x128", mutant)[:3]) > ATOL


def test_f32_routes_to_the_split_tf32_bodies_and_fits_shared_memory():
    """backward_body names "tf32x3" for f32 at both head dims; the f32
    dkv gets the workspace with G > 1; each body's tiles and shared
    memory (Tf32Dq / Tf32Dkv: Q and dO (K and V) of a block, two stages
    of the streamed tiles, rows of D + 4 floats, the ids, log-sum-exps and
    deltas, dq's partial sums at D = 256, dkv's P hand-over) fit under the
    card's 227 KB, and the blocks
    and steps divide every S the route takes."""
    f32 = torch.float32
    assert [E.backward_body(f32, d) for d in E.HEAD_DIMS] == ["tf32x3"] * 2
    assert [E.forward_body(f32, d) for d in E.HEAD_DIMS] == ["tf32x3"] * 2
    assert E.dkv_workspace(1, 256, 4, 2, 128, "cpu").dtype == f32
    for d in E.HEAD_DIMS:
        row = d + 4
        partials = 8 * DQ_KEYS[d] * 32 if DQ_SPLIT[d] > 1 else 0
        dq = (2 * DQ_ROWS[d] * row + STAGES * (2 * DQ_KEYS[d] * row
                                               + DQ_KEYS[d])
              + DQ_ROWS[d] + partials) * 4
        dkv = (2 * DKV_KEYS * row
               + STAGES * (2 * DKV_QUERIES[d] * row + 3 * DKV_QUERIES[d])
               + DKV_KEYS * DKV_QUERIES[d]) * 4
        assert dq <= MAX_SHARED_BYTES and dkv <= MAX_SHARED_BYTES, (d, dq, dkv)
        for n in (DQ_ROWS[d], DQ_KEYS[d], DKV_KEYS, DKV_QUERIES[d]):
            assert E.SEQ_MULTIPLE % n == 0
