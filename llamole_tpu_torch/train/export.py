"""Adapter export (counterpart of llamole_tpu/train/export.py): merge the
LoRA adapter into the base weights and write the merged model.

    merge_adapter(args, export_dir, device="cuda")

builds the GraphLM through build_graph_lm (base weights from
model_name_or_path, the adapter and connectors from
adapter_name_or_path), then writes into export_dir what the JAX package
writes there: adapter.msgpack, connector/*.msgpack and
graphllm_config.json (save_pretrained, before the merge), model.msgpack
(the merged LLM's JAX tree), the merged HF checkpoint in export_size GB
shards with config.json, and the tokenizer where it can save itself.
A DoRA adapter merges as its magnitude-scaled direction, a PiSSA export
(rank 2r over the original weights) as any LoRA (gllm/lora.py
merge_lora). A quantized base (quantization_bit set) is refused before
anything is built or written.
"""

import os
from typing import Any, Optional

from ..config import get_infer_args
from ..models.gllm.convert import export_hf_weights
from ..models.gllm.lora import merge_lora
from ..models.loader import build_graph_lm, llm_quantization
from ..utils.logging import get_logger
from ..utils.serialization import save_pytree
from ..weights import llm_tree

logger = get_logger(__name__)


def merge_adapter(args: Any = None, export_dir: Optional[str] = None, *,
                  device="cuda") -> str:
    """Returns export_dir. device: "cuda" (default; raises without a
    card) or "cpu"."""
    from ..serve import resolve_device

    model_args, data_args, _, finetuning_args, _ = get_infer_args(args)
    export_dir = export_dir or getattr(model_args, "export_dir", None)
    if export_dir is None and isinstance(args, dict):
        export_dir = args.get("export_dir")
    if export_dir is None:
        raise ValueError("export_dir is required for export.")
    if llm_quantization(model_args) is not None:
        raise ValueError("merge_adapter: quantization_bit is set, and an "
                         "adapter merges into a dense base only")
    model, tokenizer = build_graph_lm(
        model_args, data_args, finetuning_args, device=resolve_device(device),
        load_adapter=bool(model_args.adapter_name_or_path))
    os.makedirs(export_dir, exist_ok=True)
    model.save_pretrained(export_dir)
    merged = merge_lora(model.llm)
    logger.info("Merged %d LoRA projections", merged)
    save_pytree(llm_tree(model.llm), os.path.join(export_dir, "model.msgpack"))
    export_hf_weights(model.llm, export_dir,
                      shard_gb=float(getattr(model_args, "export_size", 5)))
    if hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(export_dir)
    logger.info("Merged model exported to %s", export_dir)
    return export_dir
