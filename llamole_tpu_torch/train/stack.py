"""Train a small but real Llamole stack end to end with the port and
record its operating point (counterpart of scripts/train_tiny_stack.py).

One command, no downloads: a verified-solvable synthetic MolQA corpus
(data/synthetic.py), the five graph-module pretrainings
(train/pretrain.py: GraphDiT, the template predictor, its CostMLP,
GraphCLIP, the property oracle), a from-scratch LLM config, mmsft (full
finetuning of that LLM plus the connectors over the trained graph
modules, through run_mmsft), then the two-phase MolQA eval (run_molqa,
per-molecule planning wall, oracle property metrics) and
OPERATING_POINT.json with every stage's metrics. Every module is saved
in the JAX package's layout, the mmsft bundle included.

    python -m llamole_tpu_torch.train.stack                 # full run, card
    python -m llamole_tpu_torch.train.stack --tiny --device cpu   # smoke
    python -m llamole_tpu_torch.train.stack --stages eval   # one stage
"""

import argparse
import json
import os
import time
from typing import Any, Dict

STAGES = ["corpus", "graphdit", "predictor", "cost_mlp", "graphclip",
          "oracle", "llm_config", "mmsft", "eval"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stack-dir", default="saves/synth-stack")
    p.add_argument("--tiny", action="store_true",
                   help="CPU-smoke sizes (tests use this)")
    p.add_argument("--stages", default=None,
                   help="comma-separated subset of: " + ",".join(STAGES))
    p.add_argument("--train-records", type=int, default=None)
    p.add_argument("--eval-records", type=int, default=None)
    p.add_argument("--epochs", type=float, default=None)
    p.add_argument("--graphdit-steps", type=int, default=None,
                   help="override GraphDiT pretrain steps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def sizes(tiny: bool) -> Dict[str, Any]:
    """Stage hyperparameters: the CPU smoke or the full run (the JAX
    script's, scripts/train_tiny_stack.py sizes)."""
    if tiny:
        return {
            "train_records": 24, "eval_records": 3,
            "graphdit": dict(hidden_size=32, depth=2, num_heads=4,
                             diffusion_steps=12, steps=8, batch_size=8),
            "predictor": dict(hidden_size=32, num_layer=2, steps=8,
                              batch_size=8),
            "cost_mlp": dict(steps=8, batch_size=16),
            "graphclip": dict(steps=8, batch_size=8, hidden_size=32,
                              num_layer=2, text_hash_dim=256),
            "oracle": dict(hidden_size=32, num_layer=2, steps=8,
                           batch_size=8),
            "llm": dict(hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2),
            "mmsft": dict(cutoff_len=256, per_device_train_batch_size=2,
                          num_train_epochs=1.0, max_steps=2,
                          learning_rate=1e-3),
            "eval": dict(per_device_eval_batch_size=2, max_new_tokens=16,
                         expansion_topk=10, iterations=3,
                         max_planning_time=3.0),
        }
    return {
        "train_records": 2000, "eval_records": 64,
        "graphdit": dict(hidden_size=256, depth=6, num_heads=8,
                         diffusion_steps=100, steps=4000, batch_size=64,
                         learning_rate=2e-4),
        "predictor": dict(hidden_size=128, num_layer=3, steps=2000,
                          batch_size=64),
        "cost_mlp": dict(steps=600, batch_size=128),
        "graphclip": dict(steps=1200, batch_size=64),
        "oracle": dict(hidden_size=128, num_layer=3, steps=2000,
                       batch_size=64),
        "llm": dict(hidden_size=256, intermediate_size=768,
                    num_hidden_layers=6, num_attention_heads=8,
                    num_key_value_heads=4),
        "mmsft": dict(cutoff_len=1024, per_device_train_batch_size=8,
                      num_train_epochs=8.0, learning_rate=3e-4),
        # the reference eval budgets
        "eval": dict(per_device_eval_batch_size=8, max_new_tokens=256,
                     expansion_topk=50, iterations=100,
                     max_planning_time=30.0),
    }


def stack_paths(stack_dir: str) -> Dict[str, str]:
    d = os.path.abspath(stack_dir)
    paths = {k: os.path.join(d, k) for k in
             ("graphdit", "predictor", "graphclip", "oracle", "llm",
              "mmsft", "eval")}
    paths["data"] = os.path.join(d, "data")
    paths["corpus_train"] = os.path.join(paths["data"], "corpus_train.json")
    paths["corpus_eval"] = os.path.join(paths["data"], "corpus_eval.json")
    return paths


def llm_config(llm_sizes: Dict[str, int]) -> Dict[str, Any]:
    """The from-scratch LLM's config.json (llama family, tied
    embeddings; the vocab grows to the tokenizer's at load)."""
    return {"model_type": "llama", "vocab_size": 320,
            "max_position_embeddings": 2048, "rope_theta": 10000.0,
            "rms_norm_eps": 1e-5, "tie_word_embeddings": True, **llm_sizes}


def _model_args(paths: Dict[str, str]) -> Dict[str, str]:
    return {"model_name_or_path": paths["llm"],
            "graph_decoder_path": paths["graphdit"],
            "graph_predictor_path": paths["predictor"],
            "graph_encoder_path": paths["graphclip"]}


def mmsft_args(paths: Dict[str, str], mmsft: Dict[str, Any],
               seed: int) -> Dict[str, Any]:
    """run_mmsft's arguments: full finetuning of the LLM and the
    connectors over the frozen trained graph modules."""
    return {**_model_args(paths), "dataset": "corpus_train",
            "dataset_dir": paths["data"], "template": "default",
            "learned_query_size": 8, "do_train": True,
            "output_dir": paths["mmsft"], "overwrite_output_dir": True,
            "finetuning_type": "full", "gradient_accumulation_steps": 1,
            "lr_scheduler_type": "cosine", "warmup_ratio": 0.03,
            "logging_steps": 25, "save_steps": 250, "val_size": 0.0,
            "plot_loss": True, "seed": seed, **mmsft}


def eval_args(paths: Dict[str, str], ev: Dict[str, Any],
              seed: int) -> Dict[str, Any]:
    """run_molqa's arguments: the trained stack with the mmsft bundle as
    its adapter and the oracle scoring the designed molecules."""
    return {**_model_args(paths), "adapter_name_or_path": paths["mmsft"],
            "property_oracle_path": paths["oracle"],
            "dataset": "corpus_eval", "dataset_dir": paths["data"],
            "template": "default", "learned_query_size": 8,
            "do_train": False, "output_dir": paths["eval"],
            "per_device_eval_batch_size": ev["per_device_eval_batch_size"],
            "max_new_tokens": ev["max_new_tokens"], "temperature": 0.6,
            "top_p": 0.9, "finetuning_type": "full", "seed": seed}


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)
    cfg = sizes(args.tiny)
    if args.train_records:
        cfg["train_records"] = args.train_records
    if args.eval_records:
        cfg["eval_records"] = args.eval_records
    if args.epochs:
        cfg["mmsft"]["num_train_epochs"] = args.epochs
    if args.graphdit_steps:
        cfg["graphdit"]["steps"] = args.graphdit_steps
    run_stages = args.stages.split(",") if args.stages else STAGES
    for s in run_stages:
        if s not in STAGES:
            raise SystemExit(f"unknown stage {s!r} (known: {STAGES})")

    from ..serve import resolve_device
    device = resolve_device(args.device)
    paths = stack_paths(args.stack_dir)
    d = os.path.dirname(paths["data"])
    report = {"tiny": bool(args.tiny), "stack_dir": d, "stages": {}}
    report_path = os.path.join(d, "OPERATING_POINT.json")
    if os.path.exists(report_path):
        with open(report_path) as f:
            try:
                report = json.load(f)
            except ValueError:
                pass
        report["tiny"] = bool(args.tiny)

    def record(stage, metrics, t0):
        metrics = {k: v for k, v in (metrics or {}).items()
                   if k != "losses"}
        metrics["wall_s"] = round(time.time() - t0, 1)
        report["stages"][stage] = metrics
        os.makedirs(d, exist_ok=True)
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
        print(f"[stack] {stage}: {metrics}", flush=True)

    if "corpus" in run_stages:
        t0 = time.time()
        from ..data.synthetic import write_corpus
        m_train = write_corpus(paths["corpus_train"], cfg["train_records"],
                               seed=args.seed)
        m_eval = write_corpus(paths["corpus_eval"], cfg["eval_records"],
                              seed=args.seed + 100)
        record("corpus", {"train": m_train, "eval": m_eval}, t0)

    from . import pretrain
    # the cost model rides the predictor's directory, where the loader
    # finds cost_model.msgpack
    for stage, fn, out in (
            ("graphdit", pretrain.pretrain_graphdit, "graphdit"),
            ("predictor", pretrain.pretrain_predictor, "predictor"),
            ("cost_mlp", pretrain.pretrain_cost_mlp, "predictor"),
            ("graphclip", pretrain.pretrain_graphclip, "graphclip"),
            ("oracle", pretrain.pretrain_property_oracle, "oracle")):
        if stage in run_stages:
            t0 = time.time()
            record(stage, fn(paths["corpus_train"], paths[out],
                             seed=args.seed, device=device, **cfg[stage]),
                   t0)

    if "llm_config" in run_stages:
        t0 = time.time()
        os.makedirs(paths["llm"], exist_ok=True)
        llm_cfg = llm_config(cfg["llm"])
        with open(os.path.join(paths["llm"], "config.json"), "w") as f:
            json.dump(llm_cfg, f, indent=1)
        record("llm_config", llm_cfg, t0)

    if "mmsft" in run_stages:
        t0 = time.time()
        from ..config import get_train_args
        from .workflow import run_mmsft
        record("mmsft", run_mmsft(*get_train_args(mmsft_args(
            paths, cfg["mmsft"], args.seed)), device=device), t0)

    if "eval" in run_stages:
        t0 = time.time()
        from ..config import get_infer_args
        from ..eval.workflow import run_molqa
        ev = cfg["eval"]
        run_molqa(*get_infer_args(eval_args(paths, ev, args.seed)),
                  expansion_topk=ev["expansion_topk"],
                  iterations=ev["iterations"],
                  max_planning_time=ev["max_planning_time"],
                  share_planning_wall=False, device=device)
        with open(os.path.join(paths["eval"], "molqa_results.json")) as f:
            summary = json.load(f)["summary"]
        record("eval", summary, t0)
        print(json.dumps({"operating_point": summary}), flush=True)

    print(f"[stack] report: {report_path}", flush=True)
    return report


if __name__ == "__main__":
    main()
