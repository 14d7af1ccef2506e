"""One-command parity eval: reference checkpoints -> 12-metric table
(counterpart of llamole_tpu/eval/parity.py).

`python -m llamole_tpu_torch parity --ckpt-dir ckpt/`:

  1. discovers the reference-layout checkpoint directories under
     --ckpt-dir by CONTENT (graphdit: model.pt + config.yaml + data.meta;
     encoder: model.pt + model_proj.pt; predictor: model.pt +
     label_to_template.csv.gz; adapter: graph_to_lm_connector.pt;
     base LLM: config.json + *.safetensors),
  2. converts each torch checkpoint into the JAX package's msgpack layout
     (models/refconvert.py; kinds already converted are skipped),
  3. trains the property oracle on a MolQA corpus (--oracle-corpus) or
     reuses one (--oracle),
  4. builds the composite on `device` and runs the two-phase MolQA eval
     (eval/workflow.py run_molqa) with the reference budgets (topk 50,
     100 iterations, a full planning wall per molecule) and no design
     resampling,
  5. writes `parity_table.json` with the paper's 12 metric families
     (the JAX package's keys) and prints the table.
"""

import json
import os
from typing import Any, Dict, Optional

from ..utils.logging import get_logger

logger = get_logger(__name__)

# content signatures for reference-layout checkpoint directories
_SIGNATURES = {
    "graphdit": ("model.pt", ("config.yaml", "model_config.yaml")),
    "encoder": ("model.pt", ("model_proj.pt",)),
    "predictor": ("model.pt", ("label_to_template.csv.gz",)),
    "adapter": ("graph_to_lm_connector.pt", ()),
}


def _matches(path: str, kind: str) -> bool:
    need, any_of = _SIGNATURES[kind]
    if not os.path.exists(os.path.join(path, need)):
        return False
    return not any_of or any(
        os.path.exists(os.path.join(path, n)) for n in any_of)


def _is_base_llm(path: str) -> bool:
    if not os.path.exists(os.path.join(path, "config.json")):
        return False
    try:
        names = os.listdir(path)
    except OSError:
        return False
    return any(n.endswith(".safetensors") for n in names)


def discover_checkpoints(ckpt_dir: str) -> Dict[str, str]:
    """Map kind -> source dir by content signature. Searches ckpt_dir
    itself plus immediate subdirectories; two dirs matching one kind is
    an error (the caller passes explicit paths)."""
    candidates = [ckpt_dir] + sorted(
        os.path.join(ckpt_dir, d) for d in os.listdir(ckpt_dir)
        if os.path.isdir(os.path.join(ckpt_dir, d)))
    found: Dict[str, str] = {}
    for kind in _SIGNATURES:
        hits = [c for c in candidates if _matches(c, kind)]
        # a dir with model.pt can match several kinds: the most specific
        # signature wins
        if kind == "graphdit":
            hits = [h for h in hits if not _matches(h, "encoder")]
        if kind in ("graphdit", "encoder"):
            hits = [h for h in hits if not _matches(h, "predictor")]
        if len(hits) > 1:
            raise ValueError(
                f"ambiguous {kind} checkpoint: {hits} — pass an explicit "
                f"--{kind} path")
        if hits:
            found[kind] = hits[0]
    llm_hits = [c for c in candidates if _is_base_llm(c)]
    if len(llm_hits) > 1:
        raise ValueError(f"ambiguous base LLM dir: {llm_hits} — pass "
                         "--base-llm")
    if llm_hits:
        found["base_llm"] = llm_hits[0]
    return found


def _convert_all(sources: Dict[str, str], out_dir: str) -> Dict[str, str]:
    """Convert each discovered torch checkpoint into out_dir/converted/
    (skipping kinds whose converted tree already exists)."""
    from ..models import refconvert

    converters = {"graphdit": refconvert.convert_graphdit,
                  "encoder": refconvert.convert_encoder,
                  "predictor": refconvert.convert_predictor,
                  "adapter": refconvert.convert_connectors}
    markers = {"graphdit": "model.msgpack", "encoder": "model.msgpack",
               "predictor": "model.msgpack",
               "adapter": os.path.join("connector", "graph_to_lm.msgpack")}
    converted: Dict[str, str] = {}
    for kind, fn in converters.items():
        if kind not in sources:
            continue
        dst = os.path.join(out_dir, "converted", kind)
        if os.path.exists(os.path.join(dst, markers[kind])):
            logger.info("parity: %s already converted at %s", kind, dst)
        else:
            fn(sources[kind], dst)
        converted[kind] = dst
    return converted


def _flatten_table(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The 12 paper metric families as one flat, printable table."""
    from ..utils.constants import MOL_PROPERTIES

    acc = summary.get("property_accuracy") or {}
    mae = summary.get("property_mae") or {}
    text = summary.get("text_metrics") or {}
    table: Dict[str, Any] = {
        "validity": summary.get("validity"),
        "retro_success": summary.get("retro_success"),
    }
    for name in MOL_PROPERTIES[:3]:            # binary: accuracy
        table[f"acc_{name}"] = acc.get(name)
    for name in MOL_PROPERTIES[3:]:            # continuous: MAE
        table[f"mae_{name}"] = mae.get(name)
    table.update({
        "bleu4": text.get("bleu-4"),
        "rouge1": text.get("rouge-1"),
        "rouge2": text.get("rouge-2"),
        "rougeL": text.get("rouge-l"),
        "uniqueness": summary.get("uniqueness"),
        "novelty": summary.get("novelty"),
        "fgd": summary.get("fgd"),
        "num_records": summary.get("num_records"),
        "molecules_per_min": summary.get("molecules_per_min"),
    })
    return table


def run_parity(
    ckpt_dir: Optional[str] = None,
    *,
    base_llm: Optional[str] = None,
    graphdit: Optional[str] = None,
    encoder: Optional[str] = None,
    predictor: Optional[str] = None,
    adapter: Optional[str] = None,
    oracle: Optional[str] = None,
    oracle_corpus: Optional[str] = None,
    dataset: str = "molqa_drug_examples",
    dataset_dir: str = "data",
    output_dir: str = "saves/parity",
    records: Optional[int] = None,
    batch_size: int = 8,
    template: str = "default",
    cutoff_len: int = 512,
    max_new_tokens: int = 128,
    frontier_width: int = 8,
    expansion_topk: int = 50,
    iterations: int = 100,
    max_planning_time: float = 30.0,
    seed: int = 0,
    device="cuda",
) -> Dict[str, Any]:
    """Checkpoints -> converted trees -> two-phase MolQA on `device`
    (default the card; without one it raises unless device="cpu") ->
    metric table.

    Explicit per-kind paths override discovery under ckpt_dir. Returns
    the flat table (also written to output_dir/parity_table.json; the
    full result records land in output_dir/molqa_results.json)."""
    from ..config import (DataArguments, FinetuningArguments,
                          GeneratingArguments, ModelArguments,
                          TrainingArguments)
    from ..models.loader import build_graph_lm
    from ..serve import resolve_device
    from .workflow import run_molqa

    device = resolve_device(device)
    sources = discover_checkpoints(ckpt_dir) if ckpt_dir else {}
    for kind, override in (("graphdit", graphdit), ("encoder", encoder),
                           ("predictor", predictor), ("adapter", adapter),
                           ("base_llm", base_llm)):
        if override:
            sources[kind] = override
    missing = [k for k in ("graphdit", "encoder", "predictor")
               if k not in sources]
    if missing:
        raise ValueError(
            f"no checkpoint found for {missing} under "
            f"{ckpt_dir!r} — expected the reference HF layouts "
            "(scripts/REAL_WEIGHTS_RUNBOOK.md §1) or explicit paths")
    logger.info("parity sources: %s", sources)

    os.makedirs(output_dir, exist_ok=True)
    converted = _convert_all(
        {k: v for k, v in sources.items() if k != "base_llm"}, output_dir)

    # property oracle: reuse, or train on the supplied corpus
    oracle_path = oracle
    if oracle_path is None and oracle_corpus:
        oracle_path = os.path.join(output_dir, "oracle")
        if not os.path.exists(os.path.join(oracle_path, "model.msgpack")):
            from ..train.pretrain import pretrain_property_oracle
            logger.info("parity: training property oracle on %s",
                        oracle_corpus)
            pretrain_property_oracle(oracle_corpus, oracle_path,
                                     device=device)

    model_args = ModelArguments(
        model_name_or_path=sources.get("base_llm", ""),
        graph_decoder_path=converted["graphdit"],
        graph_encoder_path=converted["encoder"],
        graph_predictor_path=converted["predictor"],
        adapter_name_or_path=converted.get("adapter"),
        property_oracle_path=oracle_path,
    )
    data_args = DataArguments(dataset=dataset, dataset_dir=dataset_dir,
                              template=template, cutoff_len=cutoff_len,
                              learned_query_size=8)
    training_args = TrainingArguments(per_device_eval_batch_size=batch_size,
                                      output_dir=output_dir, seed=seed)
    ft_args = FinetuningArguments(finetuning_type="freeze")
    gen_args = GeneratingArguments(max_new_tokens=max_new_tokens,
                                   temperature=0.6, top_p=0.9,
                                   do_sample=True,
                                   frontier_width=frontier_width)

    model, tokenizer = build_graph_lm(
        model_args, data_args, ft_args, device=device, seed=seed,
        generate_mode=True, load_adapter="adapter" in converted)
    run_molqa(model_args, data_args, training_args, ft_args, gen_args,
              max_records=records, prebuilt=(model, tokenizer),
              expansion_topk=expansion_topk, iterations=iterations,
              max_planning_time=max_planning_time,
              # quality parity = the reference's engine budget: each
              # molecule's search gets a full planning wall of its own,
              # not the throughput-oriented shared wall
              share_planning_wall=False,
              # the reference rolls straight back to the LLM's text on a
              # failed diffusion sample: no resampling in the table
              design_resamples=0)

    with open(os.path.join(output_dir, "molqa_results.json")) as f:
        summary = json.load(f)["summary"]
    table = _flatten_table(summary)
    with open(os.path.join(output_dir, "parity_table.json"), "w") as f:
        json.dump(table, f, indent=1)

    width = max(len(k) for k in table)
    lines = ["parity table (vs arXiv 2410.04223 paper metrics):"]
    for k, v in table.items():
        shown = "n/a" if v is None else (
            f"{v:.4f}" if isinstance(v, float) else str(v))
        lines.append(f"  {k:<{width}}  {shown}")
    print("\n".join(lines))
    return table
