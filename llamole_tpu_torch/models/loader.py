"""Model assembly (counterpart of llamole_tpu/models/loader.py).

`build_graph_lm_from_configs` builds the Phase-1 GraphLM from config
objects alone (no YAML, no files): random weights drawn ON the target
device from one seeded torch.Generator. `build_graph_lm` mirrors the JAX
loader's argument-driven path: tokenizer, resolve_llm_config,
vocab = max(config, tokenizer), and the documented random-init
fallbacks. Reading trained weights from checkpoint files is not ported
yet (ROADMAP.md); paths that hold them raise.
"""

import os
from typing import Optional

import torch

from llamole_tpu.data.tokenizer import ByteTokenizer, load_tokenizer
from llamole_tpu.utils.constants import SPECIAL_TOKENS
from llamole_tpu.utils.logging import get_logger

from .composite import GraphLM
from .gllm import LLM, LLMConfig
from .graphdit import GraphDiT, GraphDiTConfig
from .graphdit.config import DataInfo, build_data_info_from_smiles

logger = get_logger(__name__)

_FALLBACK_SMILES = [
    "CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1",
    "CC(N)C(=O)O", "COC", "CS", "C=CC=C", "CC(=O)Oc1ccccc1C(=O)O",
    "c1cc[nH]c1", "CCCl", "CBr", "CF", "CCCCCC", "C1CCCCC1",
]

_NOT_PORTED = ("loading {} from {} is not ported to llamole_tpu_torch yet "
               "(ROADMAP.md: checkpoint files)")


def offline_tokenizer():
    """The byte-level tokenizer with the 9 control tokens, left-padding:
    what load_tokenizer gives when no HF tokenizer files exist."""
    tok = ByteTokenizer(SPECIAL_TOKENS)
    tok.padding_side = "left"
    return tok


def resolve_llm_config(model_args) -> LLMConfig:
    """Family preset by model name; tiny (random init) when unnamed."""
    path = model_args.model_name_or_path or ""
    if path and os.path.exists(os.path.join(path, "config.json")):
        raise NotImplementedError(_NOT_PORTED.format("an LLM config", path))
    name = path.lower()
    if "llama" in name:
        return LLMConfig.llama3_8b()
    if "qwen" in name:
        return LLMConfig.qwen2_7b()
    if "mistral" in name:
        return LLMConfig.mistral_7b()
    logger.warning("No local weights/config for %r -- using tiny config "
                   "(random init)", path)
    return LLMConfig.tiny()


def build_graph_lm_from_configs(
    llm_cfg: LLMConfig, dit_cfg: GraphDiTConfig, data_info: DataInfo,
    tokenizer, *, device, llm_dtype=torch.bfloat16,
    graph_dtype=torch.float32, seed: int = 0, finetuning_type: str = "lora",
    lora_rank: int = 8, lora_alpha: Optional[int] = None,
    use_rslora: bool = False, num_body_tokens: int = 8,
) -> GraphLM:
    """Random-init GraphLM on `device` (weights drawn there, seeded)."""
    device = torch.device(device)
    llm_cfg.vocab_size = max(llm_cfg.vocab_size, tokenizer.vocab_size)
    gen = torch.Generator(device=device).manual_seed(seed)
    llm = LLM(llm_cfg, dtype=llm_dtype, device=device)
    llm.reset_parameters(gen)
    graph_decoder = GraphDiT(dit_cfg, data_info, dtype=graph_dtype,
                             device=device)
    graph_decoder.denoiser.reset_parameters(gen)
    model = GraphLM(
        llm, graph_decoder, tokenizer,
        {t: tokenizer.token_to_id(t) for t in SPECIAL_TOKENS},
        num_body_tokens=num_body_tokens, lora_rank=lora_rank,
        lora_alpha=lora_alpha, finetuning_type=finetuning_type,
        use_rslora=use_rslora)
    model.init_trainable(gen)
    return model.eval()


def build_graph_lm(model_args, data_args, finetuning_args, *, device,
                   seed: int = 0, generate_mode: bool = False,
                   load_adapter: bool = False):
    """Argument-driven build (llamole_tpu.config dataclasses).
    Returns (model, tokenizer)."""
    if getattr(model_args, "quantization_bit", None) is not None:
        raise NotImplementedError("quantized LLM weights are not ported yet "
                                  "(ROADMAP.md)")
    if getattr(finetuning_args, "use_dora", False) or getattr(
            finetuning_args, "pissa_init", False):
        raise NotImplementedError("DoRA / PiSSA adapters are not ported yet "
                                  "(ROADMAP.md)")
    tokenizer = load_tokenizer(model_args, generate_mode=generate_mode)
    llm_cfg = resolve_llm_config(model_args)
    llm_cfg.kv_cache_dtype = getattr(model_args, "kv_cache_dtype",
                                     "compute") or "compute"
    if getattr(model_args, "num_experts", 0):
        llm_cfg.num_experts = int(model_args.num_experts)

    gd_path = model_args.graph_decoder_path
    if gd_path and os.path.exists(os.path.join(gd_path, "model.msgpack")):
        raise NotImplementedError(_NOT_PORTED.format("GraphDiT", gd_path))
    logger.warning("graph_decoder_path missing (%s); tiny random init",
                   gd_path)
    info = build_data_info_from_smiles(_FALLBACK_SMILES, max_n_nodes=16)
    dit_cfg = GraphDiTConfig(
        hidden_size=64, depth=2, num_heads=4, diffusion_steps=20,
        text_dim=768,
        sampling_steps=getattr(model_args, "diffusion_sampling_steps", None))
    if load_adapter and model_args.adapter_name_or_path:
        raise NotImplementedError(_NOT_PORTED.format(
            "a trained adapter", model_args.adapter_name_or_path))

    model = build_graph_lm_from_configs(
        llm_cfg, dit_cfg, info, tokenizer, device=device,
        llm_dtype=(torch.bfloat16 if model_args.compute_dtype == "bfloat16"
                   else torch.float32),
        seed=seed, finetuning_type=finetuning_args.finetuning_type,
        lora_rank=finetuning_args.lora_rank,
        lora_alpha=finetuning_args.lora_alpha,
        use_rslora=getattr(finetuning_args, "use_rslora", False),
        num_body_tokens=data_args.learned_query_size)
    return model, tokenizer
