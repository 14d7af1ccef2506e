"""LoRA as an overlay on the LLM's projections (counterpart of
llamole_tpu/models/gllm/lora.py and model.py _proj).

Every targeted projection computes y = x W^T + ((x A^T) B^T) * scale
(+ bias), the adapter math in the adapter's dtype (f32) and the delta
cast back to the activation dtype, as the JAX package does. A is
[r, in] and B is [out, r] (nn.Linear layout); the weight bridge
transposes the JAX [in, r] / [r, out] leaves. `merge_lora` folds the
adapters into the base weights for export (JAX lora.merge_lora).
"""

import contextlib
import threading
from typing import Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn


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


class LoRALinear(nn.Module):
    """A bias-optional projection with an optional LoRA adapter."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dtype,
                                              device=device))
                     if bias else None)
        self.lora_a = None
        self.lora_b = None
        self.lora_scale = 1.0

    def add_lora(self, rank: int, scale: float,
                 dtype=torch.float32) -> None:
        """Attach an (uninitialised) rank-r adapter on this device."""
        dev = self.weight.device
        self.lora_a = nn.Parameter(torch.empty(rank, self.weight.shape[1],
                                               dtype=dtype, device=dev))
        self.lora_b = nn.Parameter(torch.empty(self.weight.shape[0], rank,
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
        y = F.linear(x, self.weight)
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
    Returns the number of projections merged. The port holds no DoRA
    magnitude: a DoRA adapter is refused when it is loaded
    (weights.state_dict_of)."""
    merged = 0
    for m in model.modules():
        if not isinstance(m, LoRALinear) or m.lora_a is None:
            continue
        delta = (m.lora_b.float() @ m.lora_a.float()) * m.lora_scale
        m.weight.copy_((m.weight.float() + delta).to(m.weight.dtype))
        m.lora_a = None
        m.lora_b = None
        merged += 1
    return merged
