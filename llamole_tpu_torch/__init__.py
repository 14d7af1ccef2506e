"""llamole_tpu_torch — the PyTorch + CUDA port of llamole_tpu.

Molecular design and retrosynthesis serving, and mmsft training, on an
NVIDIA Hopper card.
Phase 1: the LLM (+ LoRA) decodes an analysis with a KV cache, a query
extension yields the design hidden, the lm_to_graph_decoder connector
conditions the GraphDiT sampler, and host code assembles SMILES (with LLM
rollback). Phase 2: Retro* search (planner/) expands products
with GraphCLIP embeddings spliced into the prompt, an analysis decode, a
retro query and the GIN template predictor, and values nodes with the
base LLM's likert scores. Training (run_mmsft) fits the LoRA adapter and
the three connectors through the LM, design and retro losses. Four
hand-written CUDA kernels carry the graph modules: the fused graph
attention of every sampling denoiser block (A) and the pre-split graph
attention (D) in csrc/fused_attention.cu, the GIN aggregation of every
GraphCLIP and predictor layer (B) and its backward (C) in
csrc/gin_aggregate.cu.

The JAX package `llamole_tpu` stays the reference. This package imports
neither JAX nor anything of llamole_tpu: it keeps its own copies of the
JAX-free host layers (chem, data, planner, config, utils), held to the
JAX package's by tests/test_torch_hostlayers.py.

Layering mirrors llamole_tpu:
  chem/ data/ planner/ config/ utils/
            host layers: SMILES, graphs, templates, tokenizer, chat
            template, collator, Retro* search, YAML arguments, logging
  ops/      nn blocks, attention, GIN layers, the kernel wrappers
  csrc/     CUDA sources, built at first use (ops/cuda_lib.py)
  models/   gllm (LLM + LoRA), graphdit (denoiser + sampler), graphclip
            (encoder), retro (template predictor, CostMLP), composite
            (GraphLM, both phases), loader
  weights   bridge from llamole_tpu parameter trees (numpy) to state dicts
  serve     DesignServer + JSONL serving
  eval      run_molqa, the MolQA dataset and its scores
  train     run_mmsft, the Trainer and its AdamW (python -m
            llamole_tpu_torch.train <yaml>)
  cli       python -m llamole_tpu_torch <command>: train, eval, export,
            serve, pretrain, parity (eval/parity.py), validate_data, env
  webui     the web UI (python -m llamole_tpu_torch.webui)
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
        "run_mmsft": ("llamole_tpu_torch.train.workflow", "run_mmsft"),
    }
    if name in lazy:
        import importlib
        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'llamole_tpu_torch' has no attribute {name!r}")
