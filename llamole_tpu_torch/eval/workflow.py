"""Two-phase MolQA batch evaluation with the port (counterpart of
llamole_tpu/eval/workflow.py run_molqa):

  Phase 1, design: prompts -> analysis + SMILES per record
  Phase 2, retrosynthesis: a route for every designed molecule

Writes the reference's result schema (qa_idx / instruction / input /
llm_response / llm_smiles / property / llm_reactions) and the summary
(validity, retro success, throughput, planner effort, generation-quality
scores) to <output_dir>/molqa_results.json.
"""

import json
import math
import os
import re
import time
from typing import Any, Dict, List, Optional

import torch

from llamole_tpu.chem.assemble import check_valid
from llamole_tpu.data.aligner import extract_all_smiles
from llamole_tpu.data.loader import resolve_dataset_path
from llamole_tpu.data.template import get_template
from llamole_tpu.utils.constants import MOL_PROPERTIES
from llamole_tpu.utils.logging import get_logger

from ..models.composite import GenerationSettings
from .dataset import MolQADataset

logger = get_logger(__name__)


def remove_extra_spaces(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def run_eval(args: Any = None, device="cuda") -> List[Dict[str, Any]]:
    """Config (YAML path / dict / argv) -> run_molqa on `device`."""
    from llamole_tpu.config import get_infer_args   # needs PyYAML

    return run_molqa(*get_infer_args(args), device=device)


def run_molqa(model_args, data_args, training_args, finetuning_args,
              generating_args, max_records: Optional[int] = None,
              do_retro: bool = True, prebuilt=None,
              expansion_topk: int = 50, iterations: int = 100,
              max_planning_time: float = 30.0,
              share_planning_wall: bool = False,
              min_expansions_per_mol: int = 0, design_resamples: int = 2,
              score: bool = True, device="cuda") -> List[Dict[str, Any]]:
    """prebuilt: an optional (model, tokenizer) pair, run as it is (on its
    own device); otherwise the model is built on `device` (a CUDA device
    without a card raises). The Phase-2 knobs default to the reference
    eval's (topk 50, 100 iterations, 30 s per molecule);
    share_planning_wall=False plans each molecule under its own wall, as
    the reference does. design_resamples redraws failed diffusion samples
    before the LLM rollback. The summary records both."""
    if getattr(training_args, "mesh", ""):
        raise NotImplementedError("mesh (dp-sharded) evaluation is not "
                                  "ported to llamole_tpu_torch yet "
                                  "(ROADMAP.md: parallelism)")
    if prebuilt is not None:
        model, tokenizer = prebuilt
    else:
        from ..models.loader import build_graph_lm
        from ..serve import resolve_device
        model, tokenizer = build_graph_lm(
            model_args, data_args, finetuning_args,
            device=resolve_device(device), generate_mode=True,
            load_adapter=bool(model_args.adapter_name_or_path))
    template = get_template(data_args.template, tokenizer)
    path = resolve_dataset_path(data_args.dataset, data_args.dataset_dir)
    with open(path) as f:
        records = json.load(f)
    if max_records:
        records = records[:max_records]

    dataset = MolQADataset(records, tokenizer, template, data_args.cutoff_len)
    bsz = training_args.per_device_eval_batch_size
    ga = generating_args
    gen = GenerationSettings(
        max_new_tokens=ga.max_new_tokens, temperature=ga.temperature,
        top_p=ga.top_p, top_k=0, do_sample=ga.do_sample,
        repetition_penalty=ga.repetition_penalty,
        speculative_tokens=ga.speculative_tokens,
        speculative_ngram=ga.speculative_ngram,
        design_resamples=design_resamples)
    generator = torch.Generator(device=model.device).manual_seed(
        training_args.seed)
    results: List[Dict[str, Any]] = []
    all_smiles: List[Optional[str]] = []

    t0 = time.time()
    for batch, start in dataset.batches(bsz):
        info = model.generate(
            batch["input_ids"], batch["attention_mask"], batch["property"],
            generator=generator, do_molecular_design=True,
            do_retrosynthesis=False, rollback=True, gen=gen)
        for i, smi in enumerate(info["smiles_list"]):
            rec = records[start + i]
            response = "".join(x for x in info["text_lists"][i] if x)
            results.append({
                "qa_idx": start + i,
                "instruction": rec["instruction"],
                "input": rec.get("input", ""),
                "llm_response": response,
                "response_design": remove_extra_spaces(response),
                "llm_smiles": smi,
                "property": {p: float(v) for p, v in zip(
                    MOL_PROPERTIES, batch["property"][i])
                    if not math.isnan(float(v))},
            })
            all_smiles.append(smi)
    design_time = time.time() - t0

    retro_time = 0.0
    retro_expansions: List[int] = []
    if do_retro:
        t1 = time.time()
        idx = 0
        for batch, _ in dataset.batches(bsz):
            n = batch["input_ids"].shape[0]
            info = model.generate(
                batch["input_ids"], batch["attention_mask"],
                generator=generator, do_molecular_design=False,
                do_retrosynthesis=True,
                input_smiles_list=all_smiles[idx:idx + n],
                expansion_topk=expansion_topk, iterations=iterations,
                max_planning_time=max_planning_time,
                share_planning_wall=share_planning_wall,
                min_expansions_per_mol=min_expansions_per_mol, gen=gen,
                frontier_width=getattr(ga, "frontier_width", 1))
            for i in range(n):
                result = results[idx + i]
                plan = info["retro_plan_dict"].get(result["llm_smiles"], {})
                retro_expansions.append(int(plan.get("expansions", 0)))
                result["llm_reactions"] = [
                    {"reaction": r, "template": t, "cost": c}
                    for r, t, c in zip(plan["reaction_list"],
                                       plan["templates"], plan["cost"])
                ] if plan.get("success") else []
                new_text = "".join(x for x in info["text_lists"][i] if x)
                result["llm_response"] = remove_extra_spaces(
                    result["llm_response"] + new_text)
                result["response_retro"] = remove_extra_spaces(new_text)
            idx += n
        retro_time = time.time() - t1

    n = max(len(results), 1)
    summary = {
        "num_records": len(results),
        "validity": sum(1 for r in results
                        if check_valid(r["llm_smiles"])) / n,
        "retro_success": (sum(1 for r in results if r.get("llm_reactions"))
                          / n if do_retro else None),
        "design_time_s": design_time,
        "retro_time_s": retro_time,
        "molecules_per_min": 60.0 * len(results) / max(
            design_time + retro_time, 1e-9),
        "retro_expansions_per_mol": (
            sum(retro_expansions) / max(len(retro_expansions), 1)
            if do_retro else None),
        "planning_wall": (("shared" if share_planning_wall
                           else "per_molecule") if do_retro else None),
        "min_expansions_per_mol": (min_expansions_per_mol
                                   if do_retro and share_planning_wall
                                   else None),
        "design_resamples": design_resamples,
    }
    if score:
        from .scoring import (frechet_graphclip_distance,
                              generation_set_metrics, oracle_property_metrics)
        summary.update(generation_set_metrics(results, records))
        gold = [s for rec in records
                for s in extract_all_smiles(rec.get("output", ""))]
        summary["fgd"] = frechet_graphclip_distance(
            model.graph_encoder,
            [r["llm_smiles"] for r in results if r.get("llm_smiles")], gold)
        oracle_path = getattr(model_args, "property_oracle_path", None)
        if oracle_path:
            summary.update(oracle_property_metrics(oracle_path, results))
    logger.info("molqa eval summary: %s", summary)

    if training_args.output_dir:
        os.makedirs(training_args.output_dir, exist_ok=True)
        with open(os.path.join(training_args.output_dir,
                               "molqa_results.json"), "w") as f:
            json.dump({"summary": summary, "results": results}, f, indent=1)
    return results
