"""The system under test, built from a configuration file through
llamole_tpu_torch's public entry points: the LLM from its HF config.json
(LLMConfig.from_hf_config), the graph modules from their configs, the
composite through build_graph_lm_from_configs, and every weight from the
benchmark's draws (perfbench/weights.py), never from the port's own
random init.
"""

import time

import torch

from . import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def llm_fields(cfg: dict) -> dict:
    """The decoder's sizes as the reference and the weight spec read
    them, from the configuration's HF config.json keys."""
    hf = cfg["hf_config"]
    return {"hidden_size": hf["hidden_size"],
            "intermediate_size": hf["intermediate_size"],
            "num_layers": hf["num_hidden_layers"],
            "num_heads": hf["num_attention_heads"],
            "num_kv_heads": hf["num_key_value_heads"],
            "head_dim": hf.get("head_dim"),
            "vocab_size": hf["vocab_size"],
            "rope_theta": hf["rope_theta"],
            "rms_norm_eps": hf["rms_norm_eps"],
            "attention_bias": hf.get("attention_bias",
                                     hf["model_type"] == "qwen2"),
            "dtype": cfg["dtype"]}


def weight_spec(cfg: dict, xdim: int, lora_b_std: float):
    spec_cfg = {"llm": llm_fields(cfg), "graphdit": cfg["graphdit"],
                "graphclip": cfg["graphclip"], "predictor": cfg["predictor"],
                "graph_dtype": cfg["graph_dtype"],
                "lora_rank": cfg["lora"]["rank"],
                "lora_dtype": cfg["lora"]["dtype"]}
    return weights.spec(spec_cfg, xdim, lora_b_std)


def lora_scale(cfg: dict) -> float:
    return cfg["lora"]["alpha"] / cfg["lora"]["rank"]


def tokenizer(cfg: dict):
    """The port's offline byte tokenizer with the configuration's special
    tokens (left padding, as serving pads)."""
    from llamole_tpu_torch.data.tokenizer import ByteTokenizer
    tok = ByteTokenizer(cfg["special_tokens"])
    tok.padding_side = "left"
    return tok


def build(cfg: dict, seed: int, device, corpus, lora_b_std: float,
          timings: dict):
    """(GraphLM, tokenizer, weight spec) on `device`, every weight drawn
    from `seed`. corpus: the SMILES whose statistics set GraphDiT's atom
    types and marginals. timings gets "model_s" and "weights_s"."""
    from llamole_tpu_torch.models.gllm import LLM, LLMConfig
    from llamole_tpu_torch.models.graphclip import GraphCLIP, GraphCLIPConfig
    from llamole_tpu_torch.models.graphdit import (
        GraphDiT, GraphDiTConfig, build_data_info_from_smiles)
    from llamole_tpu_torch.models.loader import build_graph_lm_from_configs
    from llamole_tpu_torch.models.retro import (GraphPredictor,
                                                GraphPredictorConfig)

    t0 = time.monotonic()
    tok = tokenizer(cfg)
    llm_cfg = LLMConfig.from_hf_config(cfg["hf_config"])
    llm_cfg.use_flash = bool(cfg.get("use_flash", False))
    llm_cfg.flash_min_seq = int(cfg.get("flash_min_seq",
                                        llm_cfg.flash_min_seq))
    llm = LLM(llm_cfg, dtype=DTYPES[cfg["dtype"]], device=device)
    gdt = DTYPES[cfg["graph_dtype"]]
    dit = cfg["graphdit"]
    info = build_data_info_from_smiles(corpus, max_n_nodes=dit["max_n_nodes"])
    dit_cfg = GraphDiTConfig(
        hidden_size=dit["hidden_size"], depth=dit["depth"],
        num_heads=dit["num_heads"], mlp_ratio=dit["mlp_ratio"],
        drop_condition=dit["drop_condition"], ydim=dit["ydim"],
        text_dim=dit["text_dim"], diffusion_steps=dit["diffusion_steps"],
        guide_scale=dit["guide_scale"], lambda_train=tuple(dit["lambda_train"]))
    decoder = GraphDiT(dit_cfg, info, dtype=gdt, device=device)
    clip = cfg["graphclip"]
    encoder = GraphCLIP(GraphCLIPConfig(num_layer=clip["num_layer"],
                                        hidden_size=clip["hidden_size"]),
                        dtype=gdt, device=device)
    pred = cfg["predictor"]
    predictor = GraphPredictor(
        GraphPredictorConfig(num_layer=pred["num_layer"],
                             hidden_size=pred["hidden_size"],
                             out_dim=pred["out_dim"],
                             text_input_size=pred["text_input_size"]),
        label_to_template={}, available=[], dtype=gdt, device=device)
    model = build_graph_lm_from_configs(
        llm_cfg, dit_cfg, info, tok, device=device, llm=llm,
        graph_decoder=decoder, graph_encoder=encoder,
        graph_predictor=predictor, finetuning_type="lora",
        lora_rank=cfg["lora"]["rank"], lora_alpha=cfg["lora"]["alpha"],
        num_body_tokens=cfg["learned_query_size"])
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    t1 = time.monotonic()
    spec = weight_spec(cfg, dit_cfg.Xdim, lora_b_std)
    weights.load_into(model, spec, seed)
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    timings["model_s"] = t1 - t0
    timings["weights_s"] = time.monotonic() - t1
    return model, tok, spec
