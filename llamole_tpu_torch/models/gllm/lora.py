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


def quantize_activations(x: torch.Tensor):
    """W8A8's per-token activation quantization (JAX _proj's w_qa branch):
    (int8 values, f32 scales [..., 1]); the amax is floored at 1e-6
    before the division by 127."""
    x32 = x.float()
    xs = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
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


def _weight_only(x, q, scale, scheme):
    if scheme == "int8":
        return F.linear(x, q.to(x.dtype)) * scale.to(x.dtype)
    return F.linear(x, _dequantize_int4(q, scale, x.dtype))


class _WeightOnlyProduct(torch.autograd.Function):
    """The weight-only product with a backward that rebuilds the compute
    dtype weight from the quantized one (what F.linear would keep is a
    compute-dtype copy of every weight: 16 GB at 8B)."""

    @staticmethod
    def forward(ctx, x, q, scale, scheme):
        ctx.save_for_backward(q, scale)
        ctx.scheme = scheme
        return _weight_only(x, q, scale, scheme)

    @staticmethod
    def backward(ctx, grad):
        q, scale = ctx.saved_tensors
        if ctx.scheme == "int8":
            # d/dx (x W^T) * s = (g * s) W, at the forward's rounding
            return (grad * scale.to(grad.dtype)) @ q.to(grad.dtype), \
                None, None, None
        return grad @ _dequantize_int4(q, scale, grad.dtype), None, None, \
            None


def quantized_product(x, q, scale, scheme: str) -> torch.Tensor:
    """x [..., in] times the quantized base -> [..., out] in x's dtype."""
    if scheme == "w8a8":
        x8, xs = quantize_activations(x)
        lead = x.shape[:-1]
        y32 = int8_matmul(x8.reshape(-1, x.shape[-1]), q.t())
        y = y32.float().reshape(*lead, -1) * xs * scale.float()
        return y.to(x.dtype)
    if torch.is_grad_enabled() and x.requires_grad:
        return _WeightOnlyProduct.apply(x, q, scale, scheme)
    return _weight_only(x, q, scale, scheme)


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
        self.lora_scale = 1.0

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
        self.lora_scale = scale

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            y = F.linear(x, self.weight)
        else:
            y = quantized_product(x, self.w_q, self.scale, self.quant)
        if self.lora_a is not None and self.lora_enabled:
            xa = F.linear(x.to(self.lora_a.dtype), self.lora_a)
            y = y + (F.linear(xa, self.lora_b) * self.lora_scale).to(y.dtype)
        if self.bias is not None:
            y = y + self.bias
        return y


@torch.no_grad()
def merge_lora(model: nn.Module) -> int:
    """Fold every adapter of `model` into its base weight, in place, and
    drop the adapters (JAX merge_lora: the delta a @ b * scale in f32,
    added to the base in f32, cast back to the base dtype). The base
    weights are written where they are, so an 8B LLM is not copied.
    Returns the number of projections merged. A quantized base is
    refused (ValueError) before anything is written, as the JAX
    merge_lora reads a dense base["w"]. The port holds no DoRA
    magnitude: a DoRA adapter is refused when it is loaded
    (weights.state_dict_of)."""
    adapted = [m for m in model.modules()
               if isinstance(m, LoRALinear) and m.lora_a is not None]
    quantized = sorted({m.quant for m in adapted if m.quant is not None})
    if quantized:
        raise ValueError(f"merge_lora: the base is quantized ({quantized}); "
                         "an adapter merges into a dense base only")
    for m in adapted:
        delta = (m.lora_b.float() @ m.lora_a.float()) * m.lora_scale
        m.weight.copy_((m.weight.float() + delta).to(m.weight.dtype))
        m.lora_a = None
        m.lora_b = None
    return len(adapted)
