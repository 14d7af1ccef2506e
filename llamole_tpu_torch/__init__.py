"""llamole_tpu_torch — the PyTorch + CUDA port of llamole_tpu.

Phase-1 molecular design serving on an NVIDIA Hopper card: the LLM
(+ LoRA) decodes an analysis with a KV cache, a query extension yields
the design hidden, the lm_to_graph_decoder connector conditions the
GraphDiT sampler, and host code assembles SMILES (with LLM rollback).
The fused graph attention of every denoiser block is a hand-written
CUDA kernel (csrc/fused_attention.cu).

The JAX package `llamole_tpu` stays the reference. This package never
imports JAX; it shares only the JAX-free host layers of llamole_tpu
(chem, data.tokenizer, utils.constants, utils.logging).

Layering mirrors llamole_tpu:
  ops/      nn blocks, attention, the fused-attention kernel wrapper
  csrc/     CUDA sources, built at first use (ops/cuda_lib.py)
  models/   gllm (LLM + LoRA), graphdit (denoiser + sampler),
            composite (GraphLM, Phase 1), loader
  weights   bridge from llamole_tpu parameter trees (numpy) to state dicts
  serve     DesignServer + JSONL serving
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (importing the package loads no torch)."""
    lazy = {
        "GraphLM": ("llamole_tpu_torch.models.composite", "GraphLM"),
        "GenerationSettings": ("llamole_tpu_torch.models.composite",
                               "GenerationSettings"),
        "build_graph_lm": ("llamole_tpu_torch.models.loader",
                           "build_graph_lm"),
        "DesignServer": ("llamole_tpu_torch.serve", "DesignServer"),
        "serve_jsonl": ("llamole_tpu_torch.serve", "serve_jsonl"),
    }
    if name in lazy:
        import importlib
        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'llamole_tpu_torch' has no attribute {name!r}")
