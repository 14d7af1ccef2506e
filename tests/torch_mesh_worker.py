"""The ranks' side of tests/test_torch_mesh_inference.py and
tests/test_torch_pipeline.py: gloo processes started by
llamole_tpu_torch.parallel.dryrun.launch, which import the port and never
JAX. The cases run on the tiny GraphLM of torch_parallel_worker; the
tests run the same cases without a mesh in their own process."""

import os
import sys

import numpy as np
import torch

from llamole_tpu_torch.models.composite import GenerationSettings
from llamole_tpu_torch.parallel import mesh_from_string
from llamole_tpu_torch.parallel.mesh import MeshGroups
from llamole_tpu_torch.parallel.sharding import shard_llm

import torch_parallel_worker as base

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# clock steps of the lockstep case: rank 0's clock ticks a second per
# read, every other rank's a thousand (alone it would stop at once)
CLOCK_STEP = {0: 1.0}
FAST_STEP = 1000.0


def gen_settings(case) -> GenerationSettings:
    return GenerationSettings(
        max_new_tokens=case["max_new_tokens"],
        do_sample=case.get("do_sample", False),
        speculative_tokens=case.get("speculative_tokens", 0),
        design_resamples=case.get("design_resamples", 0))


def run_case(model, case, groups=None, rank=0):
    """One inference case on the model (mesh-less when groups is None)
    -> a JSON-able result."""
    gen = gen_settings(case)
    generator = torch.Generator().manual_seed(case.get("seed", 0))
    if case["kind"] == "design":
        analysis, smiles = model.design_molecule(
            np.asarray(case["ids"]), np.asarray(case["mask"]),
            np.asarray(case["props"], np.float32), gen=gen,
            rollback=case.get("rollback", False), generator=generator,
            mesh=groups)
        return {"analysis": np.asarray(analysis).tolist(), "smiles": smiles}
    if case["kind"] == "retro":
        out = model.batched_one_step_reaction(
            case["products"], topk=case["topk"], gen=gen,
            analysis_tokens=case["analysis_tokens"], generator=generator,
            mesh=groups)
        return [{k: r[k] for k in ("reactants", "scores", "templates",
                                   "analysis")} for r in out]
    if case["kind"] == "lockstep":
        from llamole_tpu_torch.planner import search
        step = CLOCK_STEP.get(rank, FAST_STEP)
        ticks = [0.0]

        def clock():
            ticks[0] += step
            return ticks[0]

        real = search.time
        search.time = type("Clock", (), {"time": staticmethod(clock)})
        try:
            plans = model.retrosynthesize_batch(
                case["targets"], generator=generator,
                iterations=case["iterations"],
                max_planning_time=case["wall"], rollback=False, gen=gen,
                total_width=case["width"], expansion_topk=case["topk"],
                language_cost_weight=0.0, mesh=groups)
        finally:
            search.time = real
        return {"plans": {t: [p["success"], p["expansions"],
                              p["reaction_list"]] for t, p in plans.items()},
                "hash": hash("llamole"),
                "hashseed": os.environ.get("PYTHONHASHSEED")}
    raise ValueError(case["kind"])


def infer(rank, world, payload):
    """payload: {"state", "mesh", "cases"}: each case on the mesh, the
    LLM placed on its tp axis."""
    model = base.tiny_model(torch.load(payload["state"]))
    groups = MeshGroups(mesh_from_string(payload["mesh"], "cpu"))
    shard_llm(model.llm, groups)
    return {name: run_case(model, case, groups, rank)
            for name, case in payload["cases"].items()}


def pipeline_grads(model_or_llm, names):
    from llamole_tpu_torch.parallel.sharding import full
    named = dict(model_or_llm.named_parameters())
    return {n: full(named[n].grad).tolist() for n in names
            if named[n].grad is not None}


def pipeline_loss(rank, world, payload):
    """pipeline_lm_loss on the mesh over the pickled batch: the loss
    (the ranks' shares summed over pp and dp) and this rank's stage's
    LoRA gradients (summed over dp)."""
    from llamole_tpu_torch.parallel.comm import all_reduce_
    from llamole_tpu_torch.parallel.pipeline import (pipeline_lm_loss,
                                                     stage_of, layer_index)
    model = base.tiny_model(torch.load(payload["state"]))
    llm = model.llm
    groups = MeshGroups(mesh_from_string(payload["mesh"], "cpu"))
    batch = {k: torch.tensor(v) for k, v in payload["batch"].items()}
    share = pipeline_lm_loss(llm, groups, batch["input_ids"],
                             batch["attention_mask"], batch["labels"],
                             num_microbatches=payload["microbatches"])
    share.backward()
    loss = share.detach().clone()
    all_reduce_(loss, groups.dp_group)
    if groups.pp > 1:
        all_reduce_(loss, groups.pp_group)
    mine = [n for n, p in llm.named_parameters() if "lora_" in n and
            stage_of(layer_index(n), llm.cfg.num_layers, groups.pp)
            == groups.pp_rank]
    for n in mine:
        g = llm.get_parameter(n).grad
        all_reduce_(g, groups.dp_group)
    return {"loss": float(loss), "grads": pipeline_grads(llm, mine),
            "stage": groups.pp_rank,
            **placement(model, groups, torch.load(payload["state"]))}


def placement(model, groups, state):
    """The Trainer's stage placement (place_stages), then gather_stages:
    the bytes each layer holds once placed, and whether every tensor
    equals the loaded state once gathered."""
    from llamole_tpu_torch.parallel.pipeline import (gather_stages,
                                                     place_stages)
    place_stages(model, groups)
    held = [sum(t.untyped_storage().nbytes() for t in
                list(layer.parameters()) + list(layer.buffers()))
            for layer in model.llm.layers]
    trainable = sorted(n for n, p in model.named_parameters()
                       if p.requires_grad)
    gather_stages(model, groups)
    whole = base.tiny_model(state).state_dict()
    restored = all(torch.equal(t, whole[n])
                   for n, t in model.state_dict().items())
    return {"held": held, "trainable": trainable, "restored": restored}


def pipeline_train(rank, world, payload):
    """run_mmsft with payload["mesh"] (a pp axis) over the tiny model for
    each run of payload["runs"] ({"name", "zero", "val_size"}), into
    out/<name>; rank 0 writes the log, the bundle and the predictions."""
    for run in payload["runs"]:
        out = payload["out"]
        train_mmsft(payload["state"], os.path.join(out, run["name"]),
                    payload["mesh"], run["zero"], run.get("val_size", 0.0),
                    payload["microbatches"], run.get("design", 1.0),
                    run.get("finetuning"), run.get("dcp", False),
                    run.get("resume") and os.path.join(out, run["resume"]))
    return [r["name"] for r in payload["runs"]]


def train_mmsft(state, out_dir, mesh, zero, val_size, microbatches,
                design=1.0, finetuning=None, dcp=False, resume=None):
    """run_mmsft on the tiny model (design: its design loss weight) over
    the shipped training examples (batch 4, 4 micro steps, 2 updates, a
    constant learning rate; f32; checkpoint-2 and -4, DCP ones with dcp):
    with or without a mesh; finetuning: FinetuningArguments fields (the
    custom chain); resume: a checkpoint to start from."""
    from dataclasses import replace

    from llamole_tpu_torch.config import get_train_args
    from llamole_tpu_torch.train.workflow import run_mmsft
    args = list(get_train_args(os.path.join(ROOT, "config", "smoke",
                                            "tiny_train.yaml")))
    args[0] = replace(args[0], compute_dtype="float32")
    args[1] = replace(args[1], max_samples=None if val_size else 4,
                      val_size=val_size)
    args[2] = replace(args[2], output_dir=out_dir, mesh=mesh,
                      zero_stage=zero, per_device_train_batch_size=4,
                      gradient_accumulation_steps=2, max_steps=4,
                      num_train_epochs=4.0, logging_steps=1, save_steps=2,
                      lr_scheduler_type="constant",
                      pipeline_microbatches=microbatches,
                      resume_from_checkpoint=resume)
    args[3] = replace(args[3], **(finetuning or {}))
    args[4] = replace(args[4], max_new_tokens=8)
    model = base.tiny_model(torch.load(state), design)
    if dcp:
        os.environ["LLAMOLE_ORBAX"] = "1"
    try:
        return run_mmsft(*args, prebuilt=(model, model.tokenizer))
    finally:
        os.environ.pop("LLAMOLE_ORBAX", None)


if __name__ == "__main__":
    # torchrun ... torch_mesh_worker.py eval <yaml> [iterations wall]: the
    # port's `eval` command, its Phase-2 budget set to an iteration
    # count and a wall long enough that only the iterations stop it
    sys.argv = sys.argv[1:]
    import functools

    import llamole_tpu_torch.eval.workflow as workflow
    from llamole_tpu_torch.cli import main
    iterations, wall = int(sys.argv[2]), float(sys.argv[3])
    if int(os.environ.get("RANK", 0)) != 0:
        def refuse(*args, **kwargs):
            raise RuntimeError("only rank 0 writes molqa_results.json")
        workflow.json = type("NoWrite", (), {
            "dump": staticmethod(refuse),
            "load": staticmethod(workflow.json.load)})
    workflow.run_molqa = functools.partial(
        workflow.run_molqa, iterations=iterations, max_planning_time=wall,
        expansion_topk=5, score=False)
    main(["eval", sys.argv[1], "--device", "cpu"])
