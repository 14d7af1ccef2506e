"""run_mmsft: multimodal supervised fine-tuning end to end (counterpart of
llamole_tpu/train/workflow.py).

Data (the port's data/, numpy only, a copy of the JAX package's):
the MolQA records tokenised by the template, a val_size split off the
front, SeqGraphCollator batches in a seeded per-epoch shuffle (a resumed
run skips the batches it already consumed). The model trains on an
explicit device ("cuda" by default; without a card that raises unless
"cpu" is asked for), with the finetuning arguments' adapter (LoRA, DoRA,
PiSSA), optimizer (AdamW, or GaLore / BAdam / LoRA+) and the model
arguments' shift_attn (S²-attn). Outputs under output_dir: trainer_log.jsonl,
checkpoint-N/, the trained bundle (GraphLM.save_pretrained: a PiSSA
adapter is written as its rank-2r LoRA over the original weights),
train_results.json, the loss plot when matplotlib exists, and after
training the held-out eval loss and generated_predictions.jsonl.

With training_args.mesh ('dp:2', 'dp:2,tp:2', 'dcn:2,dp:4', 'pp:2,dp:2',
...) the run is one rank of mesh training (train/trainer.py; torchrun
starts the ranks, each calling run_mmsft): the process group starts from
torchrun's environment (NCCL on the card, gloo on the CPU), batches are
padded to a multiple of dp with inert rows (_pad_batch_rows, as the JAX
package pads) and zero_stage picks ZeRO-1 / ZeRO-3. A pp axis pipelines
the LLM's layer stack with pipeline_microbatches microbatches
(GraphLM.enable_pipeline, parallel/pipeline.py; zero_stage 3 with dp > 1
raises, as in JAX). generated_predictions.jsonl comes from the dp leg:
each dp rank decodes its share of the held-out prompts, rank 0 writes.
"""

import json
import math
import os
import random
from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from ..data.collator import SeqGraphCollator
from ..data.loader import get_dataset
from ..utils.constants import IGNORE_INDEX, NO_LABEL_INDEX
from ..utils.logging import get_logger

from .trainer import Trainer, find_last_checkpoint

logger = get_logger(__name__)


def _pad_batch_rows(batch: Dict[str, np.ndarray], rows: int,
                    pad_id: int) -> Dict[str, np.ndarray]:
    """Append `rows` inert rows (no loss contribution) so dp divides the
    batch (JAX workflow._pad_batch_rows)."""
    if rows <= 0:
        return batch
    out = dict(batch)
    width = batch["input_ids"].shape[1]
    out["input_ids"] = np.concatenate(
        [batch["input_ids"], np.full((rows, width), pad_id, np.int32)])
    out["attention_mask"] = np.concatenate(
        [batch["attention_mask"], np.zeros((rows, width), np.int32)])
    out["labels"] = np.concatenate(
        [batch["labels"], np.full((rows, width), IGNORE_INDEX, np.int32)])
    out["molecule_properties"] = np.concatenate(
        [batch["molecule_properties"],
         np.full((rows, 10), float(NO_LABEL_INDEX), np.float32)])
    for key in ("design_graph_index", "design_start_pos"):
        out[key] = np.concatenate([batch[key], np.full(rows, -1, np.int32)])
    return out


def _epoch_batches(inputs: List[Dict], collator, batch_size: int,
                   epochs: float, seed: int, dp: int = 1, pad_id: int = 0,
                   skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Seeded per-epoch shuffle; `skip` fast-forwards past the first
    `skip` batches without collating them (the shuffle is deterministic,
    so a resumed run sees the uninterrupted run's data order). dp > 1:
    each batch padded to a multiple of dp rows."""
    n_epochs = int(math.ceil(epochs))
    frac_last = epochs - int(epochs)
    rng = random.Random(seed)
    for e in range(n_epochs):
        order = list(range(len(inputs)))
        rng.shuffle(order)   # always advance the rng, even when skipping
        if e == n_epochs - 1 and frac_last > 0:
            order = order[: max(1, int(len(order) * frac_last))]
        n_batches = math.ceil(len(order) / batch_size)
        if skip >= n_batches:
            skip -= n_batches
            continue
        start = skip * batch_size
        skip = 0
        for i in range(start, len(order), batch_size):
            batch = collator([inputs[j] for j in order[i:i + batch_size]])
            if dp > 1:
                batch = _pad_batch_rows(
                    batch, (-batch["input_ids"].shape[0]) % dp, pad_id)
            yield batch


def _eval_loss(model, batches, trainer=None) -> float:
    """Mean loss(train=False) over the batches, each drawn with a
    generator seeded 0 (the JAX package's PRNGKey(0)); on a mesh each
    batch placed and its loss summed over the ranks by the trainer."""
    losses = []
    with torch.no_grad():
        for batch in batches:
            gen = torch.Generator(device=model.device).manual_seed(0)
            if trainer is None:
                losses.append(float(model.loss(batch, gen, train=False)[0]))
            else:
                loss = model.loss(trainer.place_batch(batch), gen,
                                  train=False)[0]
                losses.append(float(trainer._data_sum(loss)))
    return float(np.mean(losses))


def run_mmsft(model_args, data_args, training_args, finetuning_args,
              generating_args, *, device="cuda", prebuilt=None
              ) -> Dict[str, Any]:
    """Train the GraphLM's trainable bundle on data_args.dataset.
    prebuilt: an optional (model, tokenizer) pair, trained as it is (on
    its own device); otherwise the model is built on `device`. Returns
    the metrics (train loss, steps, runtime, per-micro-step times, eval
    loss and prediction scores when there is a validation split)."""
    mesh = None
    spec = getattr(training_args, "mesh", "")
    if spec:
        from ..parallel.mesh import (check_world, init_distributed,
                                     mesh_from_string, parse_mesh)
        dims = parse_mesh(spec)
        from ..parallel.pipeline import check_pipeline_zero
        check_pipeline_zero(dims, training_args.zero_stage)
        check_world(dims)
        kind = (prebuilt[0].device.type if prebuilt is not None
                else torch.device(device).type)
        init_distributed(kind)
        mesh = mesh_from_string(spec, kind)
        logger.info("training mesh: %s", dict(zip(mesh.mesh_dim_names,
                                                   mesh.mesh.shape)))
    if prebuilt is not None:
        model, tokenizer = prebuilt
    else:
        from ..models.loader import build_graph_lm
        from ..serve import resolve_device
        model, tokenizer = build_graph_lm(
            model_args, data_args, finetuning_args,
            device=resolve_device(device), seed=training_args.seed)
    bank, inputs = get_dataset(model_args, data_args, training_args,
                               tokenizer)

    val_inputs: List[Dict] = []
    if data_args.val_size and data_args.val_size > 0 and len(inputs) > 1:
        k = max(1, int(len(inputs) * data_args.val_size))
        val_inputs, inputs = inputs[:k], inputs[k:]

    bsz = training_args.per_device_train_batch_size
    collator = SeqGraphCollator(
        tokenizer=tokenizer, mol_id_to_graph=bank,
        max_len=data_args.cutoff_len,
        max_nodes=model.graph_decoder.cfg.max_n_nodes,
        max_graphs=max(8, bsz * 8), max_retro=max(8, bsz * 8))

    steps_per_epoch = math.ceil(len(inputs) / bsz)
    if training_args.max_steps > 0:
        total_micro = training_args.max_steps
    else:
        total_micro = int(steps_per_epoch * training_args.num_train_epochs)
    accum = max(training_args.gradient_accumulation_steps, 1)
    opt_steps = max(1, total_micro // accum)

    groups = None
    if mesh is not None:
        from ..parallel.mesh import MeshGroups
        from ..parallel.sharding import shard_graph_lm
        groups = MeshGroups(mesh)
        if groups.pp > 1:
            microbatches = max(training_args.pipeline_microbatches, 1)
            model.enable_pipeline(groups, microbatches)
            logger.info("pipeline parallelism on: pp=%d, microbatches=%d",
                        groups.pp, microbatches)
        shard_graph_lm(model, groups, zero3=training_args.zero_stage >= 3)
    trainer = Trainer(lambda batch, gen: model.loss(batch, gen, train=True),
                      model.trainable_parameters(), training_args, opt_steps,
                      finetuning_args=finetuning_args, mesh=groups)
    on_mesh = trainer if mesh is not None else None
    dp = groups.dp if mesh is not None else 1
    pad_id = tokenizer.pad_token_id
    state = trainer.init_state(training_args.seed)

    resume = training_args.resume_from_checkpoint
    if (resume is None and training_args.output_dir
            and not training_args.overwrite_output_dir):
        resume = find_last_checkpoint(training_args.output_dir)
    if resume:
        logger.info("Resuming from %s", resume)
        state = trainer.load_checkpoint(state, resume)

    def save_fn(st, path):
        trainer.save_checkpoint(st, path)
        model.save_pretrained(path)

    batches = _epoch_batches(inputs, collator, bsz,
                             training_args.num_train_epochs,
                             training_args.seed, dp, pad_id, skip=state.step)

    eval_fn = None
    if (val_inputs and training_args.eval_strategy == "steps"
            and training_args.eval_steps):
        val_batches = list(_epoch_batches(val_inputs, collator, bsz, 1.0, 0,
                                          dp, pad_id))

        def eval_fn(st):
            return _eval_loss(model, val_batches, on_mesh)

    state, metrics = trainer.train(state, batches, total_micro,
                                   save_fn=save_fn, eval_fn=eval_fn)

    out_dir = training_args.output_dir
    if out_dir:
        model.save_pretrained(out_dir)
        if not (training_args.save_steps
                and state.step % training_args.save_steps == 0):
            # the loop wrote checkpoint-N itself at a save step
            trainer.save_checkpoint(state, os.path.join(
                out_dir, f"checkpoint-{state.step}"))
        trainer.wait_for_checkpoints()
        if trainer.writer:
            with open(os.path.join(out_dir, "train_results.json"), "w") as f:
                json.dump({k: v for k, v in metrics.items()
                           if k != "step_times"}, f, indent=2)
            if training_args.plot_loss:
                plot_loss(out_dir)

    if val_inputs:
        metrics["eval_loss"] = _eval_loss(
            model, _epoch_batches(val_inputs, collator, bsz, 1.0, 0, dp,
                                  pad_id), on_mesh)
        logger.info("eval_loss: %.4f", metrics["eval_loss"])
        if out_dir:
            if groups is not None and groups.pp > 1:
                # the decode runs every layer: each stage's come back
                from ..parallel.pipeline import gather_stages
                gather_stages(model, groups)
            metrics.update(predict_with_generate(
                model, val_inputs, tokenizer, generating_args, out_dir,
                seed=training_args.seed, mesh=groups))
    logger.info("train metrics: %s", {k: v for k, v in metrics.items()
                                      if k != "step_times"})
    return metrics


def predict_with_generate(model, val_inputs, tokenizer, generating_args,
                          output_dir: str, seed: int = 0,
                          max_examples: int = 16, mesh=None
                          ) -> Dict[str, float]:
    """Greedy continuations of held-out prompts (the label-masked prefix of
    each example, one at a time) -> generated_predictions.jsonl
    ({"prompt", "label", "predict"}) and BLEU / ROUGE against the labels.
    mesh (MeshGroups): the dp leg, dp rank r decoding the examples
    i % dp == r, the predictions all-gathered; rank 0 writes."""
    from ..models.composite import GenerationSettings
    from .metric import compute_text_metrics

    gen = GenerationSettings(
        max_new_tokens=min(generating_args.max_new_tokens, 64),
        temperature=generating_args.temperature,
        top_p=generating_args.top_p, do_sample=False)
    generator = torch.Generator(device=model.device).manual_seed(seed)
    refs, prompts = [], []
    for ex in val_inputs[:max_examples]:
        ids = list(ex["input_ids"])
        labels = list(ex["labels"])
        first = next((i for i, lab in enumerate(labels)
                      if lab != IGNORE_INDEX), None)
        if not first:
            continue
        prompts.append(ids[:first])
        refs.append(tokenizer.decode([lab for lab in labels
                                      if lab != IGNORE_INDEX],
                                     skip_special_tokens=True))
    if not prompts:
        return {}
    dp, rank = (mesh.dp, mesh.dp_rank) if mesh is not None else (1, 0)
    preds = []
    for i in range(rank, len(prompts), dp):
        p_ids, p_mask = model._left_pad([prompts[i]])
        with torch.no_grad():
            toks, _ = model._generate_tokens(p_ids, p_mask, generator, gen,
                                             model._eos_ids())
        preds.append((i, tokenizer.decode(model._strip_pads(toks[0]),
                                          skip_special_tokens=True)))
    if mesh is not None:
        from ..parallel.comm import gather_rows
        preds = sorted(gather_rows(preds, mesh.dp_group, dp))
    preds = [p for _, p in preds]
    scores = compute_text_metrics(preds, refs)
    if mesh is None or torch.distributed.get_rank() == 0:
        with open(os.path.join(output_dir, "generated_predictions.jsonl"),
                  "w") as f:
            for t, p, r in zip(prompts, preds, refs):
                t = tokenizer.decode(t, skip_special_tokens=True)
                f.write(json.dumps({"prompt": t, "label": r, "predict": p})
                        + "\n")
    logger.info("prediction metrics: %s", scores)
    return {f"predict_{k}": v for k, v in scores.items()}


def plot_loss(output_dir: str) -> None:
    """EMA loss curve training_loss.png from trainer_log.jsonl; skipped
    without matplotlib."""
    log_file = os.path.join(output_dir, "trainer_log.jsonl")
    if not os.path.exists(log_file):
        return
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("matplotlib unavailable; skipping loss plot")
        return
    steps, losses = [], []
    with open(log_file) as f:
        for line in f:
            rec = json.loads(line)
            if "loss" in rec:
                steps.append(rec["current_steps"])
                losses.append(rec["loss"])
    if not losses:
        return
    ema, smoothed = 0.0, []
    for i, value in enumerate(losses):
        ema = value if i == 0 else 0.9 * ema + 0.1 * value
        smoothed.append(ema)
    plt.figure()
    plt.plot(steps, losses, alpha=0.4, label="loss")
    plt.plot(steps, smoothed, label="smoothed")
    plt.xlabel("step")
    plt.ylabel("loss")
    plt.legend()
    plt.savefig(os.path.join(output_dir, "training_loss.png"), dpi=100)
    plt.close()
