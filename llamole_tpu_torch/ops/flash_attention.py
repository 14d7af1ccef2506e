"""Causal, segment-masked GQA flash attention for the LLM (kernel E).

`flash_attention(q, k, v, segment_ids)` is the function of the JAX LLM's
flash route (llamole_tpu/models/gllm/model.py `_flash_attention`, which
calls jaxlib's Pallas TPU flash attention): q [B, S, H, D], k / v
[B, S, KV, D] and segment ids [B, S] (the LLM's attention mask, so
padding is segment 0: a pad query attends the pad keys at or before it,
and a real query only real keys) -> [B, S, H * D] in the input dtype.
Query i attends key j iff j <= i and segment_ids[i] == segment_ids[j];
logits are q.k / sqrt(D) in f32, masked ones at jaxlib's
DEFAULT_MASK_VALUE, and the probabilities are cast to v's dtype before
the value product. Query head h reads KV head h // (H / KV).

On a CUDA tensor it launches the hand-written kernels of
csrc/flash_attention.cu or raises: the forward (which also keeps the f32
log-sum-exp [B, H, S]) and, in the backward of its autograd Function, the
dq kernel (which also forms delta = rowsum(dO * O)) and then the dkv
kernel, the counterparts of jaxlib's `_flash_attention_impl`,
`_flash_attention_bwd_dq` and `_flash_attention_bwd_dkv`. It takes bf16
(warpgroup (wgmma) bodies at both head dims: the forward; dq and dkv on
128-row blocks at D = 128 and on 64-row blocks whose two warpgroups
split each step's work at D = 256) and f32 (the forward, dq and dkv on
the tensor cores in split TF32, three mma.sync TF32 passes a product),
the dkv kernel per query head in both, its f32 partials
summed over the GQA group in `dkv_workspace`; D in HEAD_DIMS and S a
multiple of SEQ_MULTIPLE (`forward_body` and `backward_body` name the
bodies). The wrapper counts
each kernel's launches (`launches_fwd`, `launches_dq`, `launches_dkv`;
`launches` is their sum). On a CPU tensor it runs
`flash_attention_reference`, the plain PyTorch version of the same
function with jaxlib's rounding points in its backward too, which the
tests and chip_smoke.py also hold the kernels against
(`flash_forward_reference` for the forward's output and log-sum-exp).
"""

import math

import torch

from . import cuda_lib
from .cuda_lib import launch

# jaxlib's DEFAULT_MASK_VALUE
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (128, 256)
SEQ_MULTIPLE = 128
COUNTS = ("launches", "launches_fwd", "launches_dq", "launches_dkv")


def forward_body(dtype: torch.dtype, d: int) -> str:
    """The forward kernel's body for an input type and head dim, as
    csrc/flash_attention.cu routes it: "wgmma" (bf16, D = 128 or 256) or
    "tf32x3" (f32, both head dims: split TF32 on mma.sync,
    `flash_fwd_tf32_kernel`)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernel takes {HEAD_DIMS}")
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def backward_body(dtype: torch.dtype, d: int) -> str:
    """The dq and dkv kernels' body for an input type and head dim, as
    csrc/flash_attention.cu routes them: "wgmma" (bf16, D = 128: 128-row
    blocks), "wgmma_wide" (bf16, D = 256: 64-row blocks whose two
    warpgroups split each step's work) or "tf32x3" (f32, both head dims:
    split TF32 on mma.sync, `flash_bwd_dq_tf32_kernel` /
    `flash_bwd_dkv_tf32_kernel`)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernel takes {HEAD_DIMS}")
    if dtype != torch.bfloat16:
        return "tf32x3"
    return "wgmma" if d == 128 else "wgmma_wide"


def _logits(q, k, segment_ids) -> torch.Tensor:
    """f32 masked logits [B, KV, G, S, S] as the kernels form them."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    logits = logits * (1.0 / math.sqrt(d))
    pos = torch.arange(s, device=q.device)
    allowed = ((pos[:, None] >= pos[None, :])[None]
               & (segment_ids[:, :, None] == segment_ids[:, None, :]))
    return torch.where(allowed[:, None, None], logits, MASK_VALUE)


def _probs(q, k, segment_ids) -> torch.Tensor:
    """f32 probabilities [B, KV, G, S, S] of the kernels' logits."""
    return torch.softmax(_logits(q, k, segment_ids), dim=-1)


def _value_product(probs, v) -> torch.Tensor:
    """P cast to v's dtype, times v: [B, S, KV, G, D]."""
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)


class _Reference(torch.autograd.Function):
    """The plain version with jaxlib's rounding points: the forward casts
    P to v's dtype before P.V (its Pallas forward body); the backward
    forms delta = rowsum(dO * O) from the output in its dtype
    (`_flash_attention_bwd`), casts P to dO's dtype for dV and dS, after
    the scale, to the input dtype for dQ and dK (its dkv and dq bodies),
    with f32 sums. In f32 every cast is exact."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids):
        b, s, h, d = q.shape
        out = _value_product(_probs(q, k, segment_ids), v)
        ctx.save_for_backward(q, k, v, segment_ids, out)
        return out.reshape(b, s, h * d)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out = ctx.saved_tensors
        b, s, h, d = q.shape
        kv = k.shape[2]
        probs = _probs(q, k, segment_ids)
        do = dout.reshape(out.shape)
        dv = torch.einsum("bkgst,bskgd->btkd", probs.to(do.dtype).float(),
                          do.float())
        dp = torch.einsum("bskgd,btkd->bkgst", do.float(), v.float())
        delta = (out.float() * do.float()).sum(-1).permute(0, 2, 3, 1)
        ds = ((dp - delta[..., None]) * probs * (1.0 / math.sqrt(d))).to(
            q.dtype).float()
        dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float())
        dk = torch.einsum("bkgst,bskgd->btkd", ds,
                          q.float().reshape(b, s, kv, h // kv, d))
        return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None)


def flash_attention_reference(q, k, v, segment_ids) -> torch.Tensor:
    """Plain PyTorch composition with the kernels' semantics and
    rounding points (_Reference), differentiable in q, k and v."""
    return _Reference.apply(q, k, v, segment_ids)


def flash_forward_reference(q, k, v, segment_ids):
    """The plain version of `flash_forward`: (out [B, S, H * D] in q's
    dtype, the natural-log log-sum-exp [B, H, S] f32 of the masked
    logits), without autograd."""
    b, s, h, d = q.shape
    with torch.no_grad():
        logits = _logits(q, k, segment_ids)
        out = _value_product(torch.softmax(logits, dim=-1), v)
        lse = torch.logsumexp(logits, dim=-1)
    return out.reshape(b, s, h * d), lse.reshape(b, h, s)


def _entry(name: str, dtype: torch.dtype):
    return cuda_lib.entry(f"llamole_flash_attention_{name}_"
                          f"{cuda_lib.dtype_suffix(dtype)}")


def _count(kind: str) -> None:
    flash_attention.launches += 1
    setattr(flash_attention, kind, getattr(flash_attention, kind) + 1)


def reset_launches() -> None:
    for key in COUNTS:
        setattr(flash_attention, key, 0)


def _dims(q, k):
    b, s, h, d = q.shape
    return b, s, h, k.shape[2], d


def flash_forward(q, k, v, seg):
    """The forward kernel's launch on checked CUDA tensors (seg int32),
    without autograd: (out [B, S, H * D], lse [B, H, S] f32)."""
    b, s, h, kv, d = _dims(q, k)
    out = torch.empty((b, s, h * d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    launch(_entry("fwd", q.dtype), q.device, "flash_attention forward",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
           out.data_ptr(), lse.data_ptr(), b, s, h, kv, d)
    _count("launches_fwd")
    return out, lse


def flash_backward_dq(q, k, v, seg, out, dout, lse):
    """The dq kernel's launch: (dq, delta [B, H, S] f32), delta =
    rowsum(dO * O), which the dkv kernel reads."""
    b, s, h, kv, d = _dims(q, k)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    launch(_entry("bwd_dq", q.dtype), q.device, "flash_attention dq",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
           out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dq.data_ptr(), b, s, h, kv, d)
    _count("launches_dq")
    return dq, delta


def dkv_workspace(b, s, h, kv, d, device):
    """The f32 workspace [2, G, B, S, KV, D] (G = H / KV) in which every
    dkv body (bf16 and f32, both head dims) keeps each query head's dK
    and dV before a second launch sums them over the group in head order
    and writes them in the input type; None with G = 1, where a block
    writes dK and dV itself."""
    g = h // kv
    if g == 1:
        return None
    return torch.empty((2, g, b, s, kv, d), dtype=torch.float32,
                       device=device)


def flash_backward_dkv(q, k, v, seg, dout, lse, delta):
    """The dkv kernel's launch on the dq kernel's delta: (dk, dv)."""
    b, s, h, kv, d = _dims(q, k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    work = dkv_workspace(b, s, h, kv, d, q.device)
    launch(_entry("bwd_dkv", q.dtype), q.device, "flash_attention dkv",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
           dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           dk.data_ptr(), dv.data_ptr(),
           0 if work is None else work.data_ptr(), b, s, h, kv, d)
    _count("launches_dkv")
    return dk, dv


def flash_backward(q, k, v, seg, out, dout, lse):
    """The dq and dkv kernels' launches on the forward's inputs and
    outputs and a contiguous, 16-byte aligned dout: (dq, dk, dv)."""
    dq, delta = flash_backward_dq(q, k, v, seg, out, dout, lse)
    return (dq, *flash_backward_dkv(q, k, v, seg, dout, lse, delta))


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, seg):
        out, lse = flash_forward(q, k, v, seg)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:
            dout = dout.clone()
        dq, dk, dv = flash_backward(q, k, v, seg, out, dout, lse)
        return dq, dk, dv, None


def _check(q, k, v, segment_ids) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, S, H, D] and k, v [B, S, KV, D]")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(f"k / v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} KV "
                         "heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernel takes {HEAD_DIMS}")
    if s < SEQ_MULTIPLE or s % SEQ_MULTIPLE:
        raise ValueError(f"S={s}: the kernel takes a positive multiple of "
                         f"{SEQ_MULTIPLE}")
    if (segment_ids.shape != (b, s) or segment_ids.dtype.is_floating_point
            or segment_ids.dtype == torch.bool):
        raise ValueError("segment_ids must be an integer [B, S] tensor")
    if any(t.device != q.device for t in (k, v, segment_ids)):
        raise ValueError("q, k, v and segment_ids must share one device")


def flash_attention(q, k, v, segment_ids) -> torch.Tensor:
    """Causal segment-masked GQA attention, [B, S, H * D]."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, segment_ids)
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel copies 16-byte rows: q, k and v must "
                         "start 16-byte aligned")
    seg = segment_ids.to(torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, seg)


reset_launches()
