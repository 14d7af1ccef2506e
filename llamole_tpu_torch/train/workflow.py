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
from ..utils.constants import IGNORE_INDEX
from ..utils.logging import get_logger

from .trainer import Trainer, find_last_checkpoint

logger = get_logger(__name__)


def _epoch_batches(inputs: List[Dict], collator, batch_size: int,
                   epochs: float, seed: int,
                   skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Seeded per-epoch shuffle; `skip` fast-forwards past the first
    `skip` batches without collating them (the shuffle is deterministic,
    so a resumed run sees the uninterrupted run's data order)."""
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
            yield collator([inputs[j] for j in order[i:i + batch_size]])


def _eval_loss(model, batches) -> float:
    """Mean loss(train=False) over the batches, each drawn with a
    generator seeded 0 (the JAX package's PRNGKey(0))."""
    losses = []
    with torch.no_grad():
        for batch in batches:
            gen = torch.Generator(device=model.device).manual_seed(0)
            losses.append(float(model.loss(batch, gen, train=False)[0]))
    return float(np.mean(losses))


def run_mmsft(model_args, data_args, training_args, finetuning_args,
              generating_args, *, device="cuda", prebuilt=None
              ) -> Dict[str, Any]:
    """Train the GraphLM's trainable bundle on data_args.dataset.
    prebuilt: an optional (model, tokenizer) pair, trained as it is (on
    its own device); otherwise the model is built on `device`. Returns
    the metrics (train loss, steps, runtime, per-micro-step times, eval
    loss and prediction scores when there is a validation split)."""
    if getattr(training_args, "mesh", ""):
        raise NotImplementedError("mesh (parallel) training is not ported to "
                                  "llamole_tpu_torch yet (ROADMAP.md)")
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

    trainer = Trainer(lambda batch, gen: model.loss(batch, gen, train=True),
                      model.trainable_parameters(), training_args, opt_steps,
                      finetuning_args=finetuning_args)
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
                             training_args.seed, skip=state.step)

    eval_fn = None
    if (val_inputs and training_args.eval_strategy == "steps"
            and training_args.eval_steps):
        val_batches = list(_epoch_batches(val_inputs, collator, bsz, 1.0, 0))

        def eval_fn(st):
            return _eval_loss(model, val_batches)

    state, metrics = trainer.train(state, batches, total_micro,
                                   save_fn=save_fn, eval_fn=eval_fn)

    out_dir = training_args.output_dir
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        model.save_pretrained(out_dir)
        trainer.save_checkpoint(state, os.path.join(
            out_dir, f"checkpoint-{state.step}"))
        with open(os.path.join(out_dir, "train_results.json"), "w") as f:
            json.dump({k: v for k, v in metrics.items()
                       if k != "step_times"}, f, indent=2)
        if training_args.plot_loss:
            plot_loss(out_dir)

    if val_inputs:
        metrics["eval_loss"] = _eval_loss(
            model, _epoch_batches(val_inputs, collator, bsz, 1.0, 0))
        logger.info("eval_loss: %.4f", metrics["eval_loss"])
        if out_dir:
            metrics.update(predict_with_generate(
                model, val_inputs, tokenizer, generating_args, out_dir,
                seed=training_args.seed))
    logger.info("train metrics: %s", {k: v for k, v in metrics.items()
                                      if k != "step_times"})
    return metrics


def predict_with_generate(model, val_inputs, tokenizer, generating_args,
                          output_dir: str, seed: int = 0,
                          max_examples: int = 16) -> Dict[str, float]:
    """Greedy continuations of held-out prompts (the label-masked prefix of
    each example) -> generated_predictions.jsonl ({"prompt", "label",
    "predict"}) and BLEU / ROUGE against the labels."""
    from ..models.composite import GenerationSettings
    from .metric import compute_text_metrics

    gen = GenerationSettings(
        max_new_tokens=min(generating_args.max_new_tokens, 64),
        temperature=generating_args.temperature,
        top_p=generating_args.top_p, do_sample=False)
    generator = torch.Generator(device=model.device).manual_seed(seed)
    preds, refs, prompts = [], [], []
    for ex in val_inputs[:max_examples]:
        ids = list(ex["input_ids"])
        labels = list(ex["labels"])
        first = next((i for i, lab in enumerate(labels)
                      if lab != IGNORE_INDEX), None)
        if not first:
            continue
        prompt = ids[:first]
        reference = tokenizer.decode([lab for lab in labels
                                      if lab != IGNORE_INDEX],
                                     skip_special_tokens=True)
        p_ids, p_mask = model._left_pad([prompt])
        with torch.no_grad():
            toks, _ = model._generate_tokens(p_ids, p_mask, generator, gen,
                                             model._eos_ids())
        preds.append(tokenizer.decode(model._strip_pads(toks[0]),
                                      skip_special_tokens=True))
        refs.append(reference)
        prompts.append(tokenizer.decode(prompt, skip_special_tokens=True))
    if not preds:
        return {}
    scores = compute_text_metrics(preds, refs)
    with open(os.path.join(output_dir, "generated_predictions.jsonl"),
              "w") as f:
        for t, p, r in zip(prompts, preds, refs):
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
