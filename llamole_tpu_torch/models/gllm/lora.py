"""LoRA as an overlay on the LLM's projections, over a dense or a
quantized base (counterpart of llamole_tpu/models/gllm/lora.py and
model.py _proj).

Every projection computes y = base(x) + ((x A^T) B^T) * scale (+ bias),
the adapter math in the adapter's dtype (f32) and the delta cast back
to the activation dtype, as the JAX package does. A is [r, in] and B is
[out, r] (nn.Linear layout); the weight bridge transposes the JAX
[in, r] / [r, out] leaves. The base is x W^T, or one of the three
quantized schemes of gllm/quantize.py at JAX _proj's rounding points:

  int8   weight-only: (x @ w_q.to(x.dtype)) * scale.to(x.dtype), the
         per-output-channel scale applied after the product
  w8a8   activations quantized per token (amax in f32 floored at 1e-6,
         / 127, round half-to-even, clip +-127), an s8 x s8 -> s32
         product through torch._int_mm, then y32 * x_scale * scale in
         f32, cast to x's dtype
  int4   weight-only, group-wise scales along the contraction. The
         weight is dequantized per call (q * scale in x's dtype) and
         multiplied once, where JAX contracts each group and scales
         after: the two orders agree within 1e-5 in f32
         (tests/test_quantize.py's bound), and dequantizing first needs
         no [groups, rows, out] temporary.

Storage: int8 / w8a8 `w_q` [out, in] int8 and `scale` [out] f32; int4
`w_q` [out, in / 2] uint8 (two values a byte, the even input column in
the low nibble) and `scale` [groups, out] f32. Quantized weights are
buffers: nothing trains them. Under autograd the weight-only products
keep the quantized weight for the backward, not a compute-dtype copy of
it (the QLoRA path). `merge_lora` folds the adapters into a dense base
(JAX lora.merge_lora) and refuses a quantized one.

On a mesh (parallel/sharding.py) the buffers are placed as JAX places
its w_q / w_qa / w_q4 and scale leaves: a column-parallel projection
holds its rows of out and multiplies by its slice of the replicated
per-channel scale (int4: its columns of the [groups, out] scale); a
row-parallel one holds its columns of in (int4: in / 2 / tp packed
bytes and groups / tp scale rows), its partial int8 products are summed
over tp before the whole scale multiplies them, and W8A8 takes each
token's amax over the whole of in (a MAX over tp) as JAX's one product
does. Under ZeRO-3 (`zero`) each rank keeps its dp chunk of the
buffers, all-gathered for each product and again for its backward.

DoRA (arXiv 2402.09353; JAX dora_init and _proj's DoRA branch): the
adapter gains a magnitude lora_m [out], and the projection is

    W' = W + scale * B A   (f32),   y = x (m * W' / (||W'|| + 1e-6))^T

with the norm of each output row over the inputs (JAX's axis 0 of its
[in, out] leaf), not detached (as JAX; peft detaches it). Under autograd
`_DoRAProduct` keeps x and the factors and rebuilds W' in the backward,
so no f32 weight outlives its projection. PiSSA (arXiv 2404.02948; JAX
pissa_init) starts the adapter at the principal rank-r part of each
weight and leaves the residual as the base; `pissa_to_lora` turns a
trained PiSSA adapter into a rank-2r LoRA over the original weights.
DoRA and PiSSA need a dense base (a quantized one raises, as in JAX).
"""

import contextlib
import threading
from typing import Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nn import int8_matmul

QUANT_SCHEMES = ("int8", "w8a8", "int4")
TARGET_ALL = ("q", "k", "v", "o", "gate", "up", "down")
_ATTN_TARGETS = ("q", "k", "v", "o")


def lora_targets(cfg, targets=TARGET_ALL):
    """The projections an adapter covers (JAX init_lora): under MoE
    (cfg.num_experts > 0) the MLP targets go, since the experts have no
    dense gate / up / down; a target list of MLP projections only raises
    there (the adapter would be empty and training a silent no-op)."""
    targets = tuple(targets)
    if cfg.num_experts > 0:
        filtered = tuple(t for t in targets if t in _ATTN_TARGETS)
        if not filtered:
            raise ValueError(
                f"LoRA targets {targets} are all MLP projections, but MoE "
                "configs route tokens through expert weights with no dense "
                "gate/up/down -- the adapter would be empty and fine-tuning "
                "a silent no-op. Target attention projections (q/k/v/o) for "
                "MoE models.")
        targets = filtered
    return targets


# The projections whose adapter is off, per thread: the switch belongs to
# the calling thread, so a forward on another thread (the continuous
# server decodes on one thread while another scores values on the base
# weights) keeps its adapter.
_off = threading.local()


@contextlib.contextmanager
def adapters_off(modules: Iterable["LoRALinear"]):
    """Inside the block, `modules` compute their base projection alone on
    the calling thread; other threads see no change."""
    before = getattr(_off, "ids", frozenset())
    _off.ids = before | {id(m) for m in modules}
    try:
        yield
    finally:
        _off.ids = before


def lora_scale(rank: int, alpha: Optional[int] = None,
               use_rslora: bool = False) -> float:
    """alpha/r, or alpha/sqrt(r) for rsLoRA."""
    a = alpha if alpha is not None else 2 * rank
    return a / (rank ** 0.5) if use_rslora else a / rank


# ---------------------------------------------------------------------------
# quantized products
# ---------------------------------------------------------------------------

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int values in [-8, 7], [..., 2k] -> uint8 [..., k]: column 2j in
    the low nibble, 2j + 1 in the high one."""
    q = q.to(torch.int8)
    lo, hi = q[..., 0::2], q[..., 1::2]
    return ((lo & 0x0F) | (hi << 4)).view(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """pack_int4's inverse: uint8 [..., k] -> int8 [..., 2k] (the shifts
    sign-extend each nibble)."""
    p = packed.view(torch.int8)
    lo, hi = (p << 4) >> 4, p >> 4
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def quantize_activations(x: torch.Tensor, group=None):
    """W8A8's per-token activation quantization (JAX _proj's w_qa branch):
    (int8 values, f32 scales [..., 1]); the amax is floored at 1e-6
    before the division by 127. group: x holds this rank's columns of
    the input and the amax is the max over the group's."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        from ...parallel.comm import all_reduce_max
        amax = all_reduce_max(amax, group)
    xs = amax.clamp_min(1e-6) / 127.0
    x8 = torch.clamp(torch.round(x32 / xs), -127, 127).to(torch.int8)
    return x8, xs


def _dequantize_int4(packed, scale, dtype) -> torch.Tensor:
    """[out, in / 2] uint8 + [G, out] scales -> the [out, in] weight in
    `dtype` (each value times its group's scale, both in `dtype`)."""
    q = unpack_int4(packed)
    out, in_dim = q.shape
    g = scale.shape[0]
    w = (q.view(out, g, in_dim // g).to(dtype)
         * scale.t().to(dtype)[:, :, None])
    return w.view(out, in_dim)


def _weight_only(x, q, scale, scheme, group=None):
    """The weight-only product; group: a row-parallel projection's tp
    group, over which the partial products are summed (int8: before the
    scale multiplies them, as JAX scales the whole product)."""
    int8 = scheme == "int8"
    y = F.linear(x, q.to(x.dtype) if int8
                 else _dequantize_int4(q, scale, x.dtype))
    if group is not None:
        torch.distributed.all_reduce(y, group=group)
    return y * scale.to(x.dtype) if int8 else y


class _WeightOnlyProduct(torch.autograd.Function):
    """The weight-only product with a backward that rebuilds the compute
    dtype weight from the quantized one (what F.linear would keep is a
    compute-dtype copy of every weight: 16 GB at 8B). gather: ZeRO-3's
    (q, scale) from this rank's chunks, called again in the backward."""

    @staticmethod
    def forward(ctx, x, q, scale, scheme, group, gather):
        ctx.save_for_backward(q, scale)
        ctx.scheme, ctx.gather = scheme, gather
        if gather is not None:
            q, scale = gather(q, scale)
        return _weight_only(x, q, scale, scheme, group)

    @staticmethod
    def backward(ctx, grad):
        q, scale = ctx.saved_tensors
        if ctx.gather is not None:
            q, scale = ctx.gather(q, scale)
        if ctx.scheme == "int8":
            # d/dx (x W^T) * s = (g * s) W, at the forward's rounding
            gx = (grad * scale.to(grad.dtype)) @ q.to(grad.dtype)
        else:
            gx = grad @ _dequantize_int4(q, scale, grad.dtype)
        return gx, None, None, None, None, None


def quantized_product(x, q, scale, scheme: str, group=None,
                      gather=None) -> torch.Tensor:
    """x [..., in] times the quantized base -> [..., out] in x's dtype.
    group: a row-parallel projection's tp group (x and q hold this
    rank's columns of in; the result is the whole product, summed over
    the group). gather: ZeRO-3's (q, scale) -> the rank's whole q and
    scale from its dp chunks (_WeightOnlyProduct)."""
    if scheme == "w8a8":
        if gather is not None:
            q, scale = gather(q, scale)
        x8, xs = quantize_activations(x, group)
        lead = x.shape[:-1]
        y32 = int8_matmul(x8.reshape(-1, x.shape[-1]), q.t())
        if group is not None:
            # the int32 partial products, summed exactly as JAX's one
            y32 = y32.contiguous()
            torch.distributed.all_reduce(y32, group=group)
        y = y32.float().reshape(*lead, -1) * xs * scale.float()
        return y.to(x.dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        return _WeightOnlyProduct.apply(x, q, scale, scheme, group, gather)
    if gather is not None:
        q, scale = gather(q, scale)
    return _weight_only(x, q, scale, scheme, group)


# ---------------------------------------------------------------------------
# DoRA
# ---------------------------------------------------------------------------

def _dora_parts(weight, a, b, m, scale, group=None):
    """(W' [out, in] f32, ||W'|| [out], m / (||W'|| + 1e-6) [out]). group:
    W' holds this rank's columns of the inputs (row-parallel) and the
    squares are summed over the group."""
    v = weight.float() + (b.float() @ a.float()) * scale
    if group is None:
        norm = torch.linalg.vector_norm(v, dim=1)
    else:
        sq = (v * v).sum(dim=1)
        torch.distributed.all_reduce(sq, group=group)
        norm = torch.sqrt(sq)
    return v, norm, m.float() / (norm + 1e-6)


def dora_weight(weight, a, b, m, scale, group=None) -> torch.Tensor:
    """DoRA's effective weight m * W' / (||W'|| + 1e-6) [out, in] in f32
    (JAX _proj: the norm over the inputs; group as in _dora_parts)."""
    v, _, col = _dora_parts(weight, a, b, m, scale, group)
    return v * col[:, None]


class _DoRAProduct(torch.autograd.Function):
    """x @ dora_weight(...)^T in x's dtype, whose backward rebuilds W'
    from the saved factors instead of keeping it: the gradients of the
    plain composition (autograd through dora_weight and F.linear) with
    their rounding points (the weight cast to x's dtype, its gradient
    taken in x's dtype and widened to f32). Row-parallel (group): the
    norm's gradient needs the sum over the group of gw . W' per row; the
    gradients of b and m stay this rank's parts (to_tp sums them)."""

    @staticmethod
    def forward(ctx, x, weight, a, b, m, scale, group):
        ctx.save_for_backward(x, weight, a, b, m)
        ctx.scale, ctx.group = scale, group
        return F.linear(x, dora_weight(weight, a, b, m, scale,
                                       group).to(x.dtype))

    @staticmethod
    def backward(ctx, grad):
        x, weight, a, b, m = ctx.saved_tensors
        s = ctx.scale
        v, norm, col = _dora_parts(weight, a, b, m, s, ctx.group)
        n = norm + 1e-6
        gx = None
        if ctx.needs_input_grad[0]:
            gx = grad @ (v * col[:, None]).to(x.dtype)
        g2 = grad.reshape(-1, grad.shape[-1])
        gw = (g2.t() @ x.reshape(-1, x.shape[-1])).float()   # [out, in]
        gcol = (gw * v).sum(dim=1)
        gm = (gcol / n).to(m.dtype)
        if ctx.group is not None:
            torch.distributed.all_reduce(gcol, group=ctx.group)
        gn = -gcol * m.float() / (n * n)
        gv = gw * col[:, None] + (gn / norm)[:, None] * v
        del gw
        ga = ((b.float().t() @ gv) * s).to(a.dtype)
        gb = ((gv @ a.float().t()) * s).to(b.dtype)
        return gx, None, ga, gb, gm, None, None


def dora_product(x, weight, a, b, m, scale, group=None) -> torch.Tensor:
    """DoRA's projection of x [..., in] -> [..., out] in x's dtype (no
    bias; group as in _dora_parts)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a, b, m)):
        return _DoRAProduct.apply(x, weight, a, b, m, scale, group)
    return F.linear(x, dora_weight(weight, a, b, m, scale, group).to(x.dtype))


class LoRALinear(nn.Module):
    """A bias-optional projection, dense or quantized, with an optional
    LoRA adapter."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dtype,
                                              device=device))
                     if bias else None)
        self.quant: Optional[str] = None
        self.lora_a = None
        self.lora_b = None
        self.lora_m = None
        self.lora_scale = 1.0

    # the tensor-parallel role (parallel/sharding.py shard_llm): None, or
    # a TP whose style is "col" (output sharded) or "row" (input sharded)
    tp = None
    # ZeRO-3 of a quantized base (parallel/sharding.py fsdp_llm): None, or
    # a Zero that all-gathers the dp chunks of w_q / scale
    zero = None

    @property
    def _device(self) -> torch.device:
        return (self.weight if self.quant is None else self.w_q).device

    def set_quantized_(self, scheme: str, w_q: torch.Tensor,
                       scale: torch.Tensor) -> None:
        """Make the base `scheme` with these values (layouts above) and
        release the dense weight."""
        if scheme not in QUANT_SCHEMES:
            raise ValueError(f"unknown quantization scheme {scheme!r}")
        cols = (self.in_features // 2 if scheme == "int4"
                else self.in_features)
        if tuple(w_q.shape) != (self.out_features, cols):
            raise ValueError(f"{scheme} weight of shape {tuple(w_q.shape)} "
                             f"for a [{self.out_features}, "
                             f"{self.in_features}] projection")
        self.weight = None
        self.quant = scheme
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)

    def add_lora(self, rank: int, scale: float,
                 dtype=torch.float32) -> None:
        """Attach an (uninitialised) rank-r adapter on this device."""
        dev = self._device
        self.lora_a = nn.Parameter(torch.empty(rank, self.in_features,
                                               dtype=dtype, device=dev))
        self.lora_b = nn.Parameter(torch.empty(self.out_features, rank,
                                               dtype=dtype, device=dev))
        self.lora_m = None
        self.lora_scale = scale

    def add_magnitude(self) -> None:
        """Attach DoRA's (uninitialised) magnitude [out] in the adapter's
        dtype; dora_init_ fills it."""
        self.lora_m = nn.Parameter(torch.empty(
            self.out_features, dtype=self.lora_a.dtype,
            device=self.lora_a.device))

    @property
    def lora_enabled(self) -> bool:
        """Whether the adapter applies on the calling thread (adapters_off
        turns it off there alone)."""
        return id(self) not in getattr(_off, "ids", ())

    @torch.no_grad()
    def reset_lora(self, generator: torch.Generator) -> None:
        """JAX init_lora: A ~ N(0, 1) / r, B = 0 (identity at start)."""
        rank = self.lora_a.shape[0]
        self.lora_a.normal_(generator=generator).div_(rank)
        self.lora_b.zero_()

    def _quantized_base(self):
        """(w_q, scale) of this rank: its tensor-parallel shards (a
        column-parallel int8 / W8A8 projection's slice of the replicated
        per-channel scale) or, under ZeRO-3, their dp chunks."""
        tp = self.tp
        if tp is None and self.zero is None:
            return self.w_q, self.scale
        from ...parallel.sharding import local
        q, scale = local(self.w_q), local(self.scale)
        if (tp is not None and tp.style == "col" and scale.dim() == 1
                and tp.size > 1):
            n = self.out_features // tp.size
            scale = scale[tp.rank * n:(tp.rank + 1) * n]
        return q, scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The projection over this rank's tensors. Tensor-parallel
        (parallel/comm.py), column style: x and the replicated A enter
        through to_tp, the output is this rank's slice of out. Row style:
        x is this rank's slice of in, the replicated B and DoRA's m enter
        through to_tp, DoRA's row norm sums its squares over the ranks
        and the partial products are summed by from_tp (a quantized base
        sums its own, module docstring, and the adapter's delta is summed
        apart). Without tp every hook is the identity."""
        tp = self.tp
        col = tp is not None and tp.style == "col"
        row = tp is not None and tp.style == "row"
        if tp is not None:
            from ...parallel.comm import from_tp, to_tp
            from ...parallel.sharding import local

        def enter(t, replicated):
            # a replicated tensor entering a product with this rank's
            # shards: its gradient is summed over the ranks
            return to_tp(t, tp.group) if replicated else t

        def mine(t):
            return t if t is None or tp is None else local(t)

        x = enter(x, col)
        adapter = self.lora_a is not None and self.lora_enabled
        if adapter:
            a = enter(mine(self.lora_a), col)
            b = enter(mine(self.lora_b), row)
        summed = False     # a row-parallel quantized base sums its own
        if adapter and self.lora_m is not None:
            # the row norm's sum over the ranks (one rank: its own norm,
            # rounded as without a mesh)
            y = dora_product(x, mine(self.weight), a, b,
                             enter(mine(self.lora_m), row), self.lora_scale,
                             tp.group if row and tp.size > 1 else None)
        else:
            if self.quant is None:
                y = F.linear(x, mine(self.weight))
            else:
                group = tp.group if row and tp.size > 1 else None
                y = quantized_product(
                    x, *self._quantized_base(), self.quant, group,
                    None if self.zero is None else self.zero.gather)
                summed = group is not None
            if adapter:
                xa = F.linear(x.to(a.dtype), a)
                delta = (F.linear(xa, b) * self.lora_scale).to(y.dtype)
                y = y + (from_tp(delta, tp.group) if summed else delta)
        if row and not summed:
            y = from_tp(y, tp.group)
        return y if self.bias is None else y + mine(self.bias)


@torch.no_grad()
def merge_lora(model: nn.Module) -> int:
    """Fold every adapter of `model` into its base weight, in place, and
    drop the adapters (JAX merge_lora: the delta a @ b * scale in f32,
    added to the base in f32, cast back to the base dtype). The base
    weights are written where they are, so an 8B LLM is not copied.
    Returns the number of projections merged. A quantized base is
    refused (ValueError) before anything is written, as the JAX
    merge_lora reads a dense base["w"]. A DoRA adapter merges as its
    magnitude-scaled direction: W' = W + delta in f32, then each output
    row times m / (||W'|| + 1e-6)."""
    adapted = [m for m in model.modules()
               if isinstance(m, LoRALinear) and m.lora_a is not None]
    quantized = sorted({m.quant for m in adapted if m.quant is not None})
    if quantized:
        raise ValueError(f"merge_lora: the base is quantized ({quantized}); "
                         "an adapter merges into a dense base only")
    for m in adapted:
        delta = (m.lora_b.float() @ m.lora_a.float()) * m.lora_scale
        w = m.weight.float() + delta
        if m.lora_m is not None:
            w = w * (m.lora_m.float()
                     / (torch.linalg.vector_norm(w, dim=1) + 1e-6))[:, None]
        m.weight.copy_(w.to(m.weight.dtype))
        m.lora_a = None
        m.lora_b = None
        m.lora_m = None
    return len(adapted)


def svd(a: torch.Tensor):
    """torch.linalg.svd(a, full_matrices=False); on the card through
    cuSOLVER's QR-based gesvd: its default Jacobi method converges slowly
    on rank-deficient matrices such as an embedding's gradient, whose
    rows are zero but for the batch's tokens."""
    return torch.linalg.svd(a, full_matrices=False,
                            driver="gesvd" if a.is_cuda else None)


def _dense(modules, what: str):
    modules = list(modules)
    quantized = sorted({m.quant for m in modules if m.quant is not None})
    if quantized:
        raise ValueError(f"{what} needs full-precision weights; the base is "
                         f"quantized ({quantized})")
    return modules


@torch.no_grad()
def pissa_init_(modules: Iterable[LoRALinear], scale: float) -> None:
    """JAX pissa_init on adapted projections, in place: with W = U S V^T
    (the JAX leaf [in, out], the port's weight transposed; an f32 SVD of
    that orientation, as JAX takes it), A = U_r sqrt(S_r) / sqrt(scale),
    B = sqrt(S_r) V_r^T / sqrt(scale), and the base becomes W - U_r S_r
    V_r^T in its dtype, so base + scale * A B is W at init. Each singular
    vector's sign is the SVD's own, which may differ from JAX's."""
    root_scale = scale ** 0.5
    for m in _dense(modules, "PiSSA"):
        r = m.lora_a.shape[0]
        w = m.weight.float().t()                  # JAX [in, out]
        u, sv, vt = svd(w)
        root = torch.sqrt(sv[:r])
        a = u[:, :r] * root[None, :]              # [in, r]
        b = root[:, None] * vt[:r]                # [r, out]
        m.lora_a.copy_((a / root_scale).t().to(m.lora_a.dtype))
        m.lora_b.copy_((b / root_scale).t().to(m.lora_b.dtype))
        m.weight.copy_((w - a @ b).t().to(m.weight.dtype))


@torch.no_grad()
def dora_init_(modules: Iterable[LoRALinear], scale: float = 0.0) -> None:
    """JAX dora_init, in place: each adapted projection gains lora_m, the
    norm over the inputs of W + scale * B A (f32; no epsilon here), in
    the adapter's dtype, so DoRA starts at the adapter's own output."""
    for m in _dense(modules, "DoRA"):
        w = m.weight.float()
        if scale:
            w = w + (m.lora_b.float() @ m.lora_a.float()) * scale
        m.add_magnitude()
        m.lora_m.copy_(torch.linalg.vector_norm(w, dim=1).to(
            m.lora_m.dtype))


def pissa_to_lora(a: torch.Tensor, b: torch.Tensor, a0: torch.Tensor,
                  b0: torch.Tensor):
    """JAX pissa_to_lora for one projection: the trained (a, b) and the
    initial (a0, b0) PiSSA factors -> the rank-2r (A, B) of a LoRA over
    the original weight, W_res + s A_t B_t = W + s [A_t | A_0] [B_t;
    -B_0] (port layout: A [2r, in], B [out, 2r])."""
    return torch.cat([a, a0], dim=0), torch.cat([b, -b0], dim=1)
