"""The yardstick's arithmetic: the card's peaks and the least time a kernel
could take, from shapes alone.

A frozen copy of chip_smoke.py's `roofline`, `attention_bound` and
`flash_bound` (bytes: each input read once and each output written once;
operations: the products the algorithm needs), so that later changes to
the smoke script cannot move the benchmark's rooflines. f32 products are
counted at the split-TF32 rate (three TF32 passes a product, 494.7 / 3
TFLOP/s) whatever body computes them, so that a kernel's share reads the
same work whoever computes it.
"""

# H100 SXM datasheet peaks (700 W): HBM bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "f32_tensor": 494.7e12 / 3,
                  "f32": 67e12}
# the whole step's peak, for the mfu metrics: dense bf16 tensor rate
MFU_PEAK_FLOPS = 989e12

_SIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def element_size(dtype) -> int:
    """Bytes of one element of a torch dtype or its name."""
    return _SIZE[str(dtype).replace("torch.", "")]


def _tensor_kind(dtype) -> str:
    return ("bf16_tensor" if str(dtype).replace("torch.", "") == "bfloat16"
            else "f32_tensor")


def roofline(nbytes: float, ops: dict):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    arith = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    return (mem, "bytes") if mem >= arith else (arith, "operations")


def attention_bound(b, n, heads, dh, dtype, layernorm):
    """Kernel A (layernorm) and D: q, k, v read once, the key mask (and A's
    four [dh] norm vectors), the output written once; the two matrix
    products on the tensor cores, ~6 f32 operations a logit and ~8 an
    element of q and k for A's LayerNorm."""
    size = element_size(dtype)
    nbytes = 4 * b * n * heads * dh * size + b * n
    ew = 6 * b * heads * n * n
    if layernorm:
        nbytes += 4 * dh * size
        ew += 8 * 2 * b * n * heads * dh
    mm = 4 * b * heads * n * n * dh
    return roofline(nbytes, {_tensor_kind(dtype): mm, "f32": ew})


def flash_bound(shape, dtype, pairs, backward):
    """Kernel E over `pairs` attended (query, key) pairs a head (causal and
    same-segment): forward reads q, k, v, the segment ids and writes the
    output and the f32 log-sum-exp; backward reads q, k, v, the segment
    ids, out, dO and the log-sum-exp and writes dq, dk, dv. Two products
    a pair in the forward, five in the backward, ~6 f32 operations a pair
    and head."""
    b, s, h, kv, d = shape
    size = element_size(dtype)
    q_bytes, kv_bytes = b * s * h * d * size, b * s * kv * d * size
    small = b * s * 4 + b * h * s * 4              # segment ids, lse
    if backward:
        nbytes = 4 * q_bytes + 4 * kv_bytes + small
    else:
        nbytes = 2 * q_bytes + 2 * kv_bytes + small
    mm = (5 if backward else 2) * 2 * h * d * pairs
    return roofline(nbytes, {_tensor_kind(dtype): mm, "f32": 6 * h * pairs})


def flash_pairs(lengths, s: int) -> int:
    """Pairs kernel E attends in one head over a right-padded batch of
    width s whose rows hold `lengths` real tokens: real queries attend
    the real keys at or before them, pad queries the pads at or before
    them (the segment ids are the attention mask)."""
    return sum(n * (n + 1) // 2 + (s - n) * (s - n + 1) // 2
               for n in lengths)
