"""llamole_tpu_torch — the PyTorch + CUDA port of llamole_tpu.

Molecular design and retrosynthesis serving on an NVIDIA Hopper card.
Phase 1: the LLM (+ LoRA) decodes an analysis with a KV cache, a query
extension yields the design hidden, the lm_to_graph_decoder connector
conditions the GraphDiT sampler, and host code assembles SMILES (with LLM
rollback). Phase 2: Retro* search (llamole_tpu.planner) expands products
with GraphCLIP embeddings spliced into the prompt, an analysis decode, a
retro query and the GIN template predictor, and values nodes with the
base LLM's likert scores. Two hand-written CUDA kernels carry the graph
modules: the fused graph attention of every denoiser block
(csrc/fused_attention.cu) and the GIN aggregation of every GraphCLIP and
predictor layer (csrc/gin_aggregate.cu).

The JAX package `llamole_tpu` stays the reference. This package never
imports JAX; it shares only the JAX-free host layers of llamole_tpu
(chem, data, planner, utils.constants, utils.logging).

Layering mirrors llamole_tpu:
  ops/      nn blocks, attention, GIN layers, the kernel wrappers
  csrc/     CUDA sources, built at first use (ops/cuda_lib.py)
  models/   gllm (LLM + LoRA), graphdit (denoiser + sampler), graphclip
            (encoder), retro (template predictor, CostMLP), composite
            (GraphLM, both phases), loader
  weights   bridge from llamole_tpu parameter trees (numpy) to state dicts
  serve     DesignServer + JSONL serving
  eval      run_molqa, the MolQA dataset and its scores
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
        "run_molqa": ("llamole_tpu_torch.eval.workflow", "run_molqa"),
    }
    if name in lazy:
        import importlib
        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'llamole_tpu_torch' has no attribute {name!r}")
