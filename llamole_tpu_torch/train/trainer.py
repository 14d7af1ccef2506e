"""The mmsft training loop (counterpart of llamole_tpu/train/trainer.py):
AdamW or the custom chain (GaLore, BAdam, LoRA+) + schedule with
gradient accumulation and clipping (train/optimizers.py),
trainer_log.jsonl records with the JAX package's keys, checkpoint-N
directories with resume discovery.

A micro step runs the loss forward, its backward and the optimizer's
accumulate (which updates the parameters at the end of each window of
gradient_accumulation_steps). Every phase ends in a device
synchronisation, so `metrics["step_times"]` holds each micro step's
forward / backward / optimizer wall seconds and its token count.

Randomness comes from one torch.Generator on the model's device, which
the loss advances; a checkpoint stores its state, so a resumed run draws
what the uninterrupted one would have. Checkpoints are the JAX package's
checkpoint-N layout (msgpack), so a run resumes across the packages.
Not ported (they raise): the `mesh` argument (data / tensor / pipeline
parallel training) and orbax checkpoints (LLAMOLE_ORBAX, backend
"orbax"; ROADMAP.md Queue 1 item 9).
"""

import glob
import hashlib
import json
import math
import os
import queue
import re
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils.constants import IGNORE_INDEX
from ..utils.logging import JsonlLogger, get_logger
from ..utils.serialization import (load_pytree, load_state, save_pytree,
                                   save_state, to_state_dict)
from ..weights import bundle_tree, trainable_values

from .optimizers import (AccumulatingAdamW, create_optimizer, global_norm,
                         int32_scalar, load_into)

logger = get_logger(__name__)

# (batch, generator) -> (loss, {"lm_loss", "design_loss", "retro_loss"})
LossFn = Callable[[Dict[str, Any], torch.Generator],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclass
class TrainState:
    step: int                    # micro steps taken
    generator: torch.Generator


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Accuracy over the unmasked shifted label positions."""
    pred = logits[:, :-1].argmax(dim=-1)
    tgt = labels[:, 1:]
    mask = tgt != IGNORE_INDEX
    return ((pred == tgt) & mask).sum() / mask.sum().clamp_min(1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, loss_fn: LossFn, params: Dict[str, torch.nn.Parameter],
                 args, num_training_steps: int, finetuning_args=None,
                 mesh=None):
        """params: the trainable bundle (GraphLM.trainable_parameters());
        num_training_steps counts optimizer updates."""
        if mesh is not None:
            raise NotImplementedError("mesh (parallel) training is not ported "
                                      "to llamole_tpu_torch yet (ROADMAP.md)")
        if os.environ.get("LLAMOLE_ORBAX"):
            raise NotImplementedError(
                "orbax checkpoints (LLAMOLE_ORBAX) are not ported to "
                "llamole_tpu_torch (ROADMAP.md Queue 1 item 9: they shard "
                "state across chips, with parallelism)")
        if not params:
            raise ValueError("no trainable parameters")
        self.loss_fn = loss_fn
        self.params = params
        self.args = args
        self.device = next(iter(params.values())).device
        self.num_training_steps = num_training_steps
        self.optimizer, self.schedule = create_optimizer(
            args, num_training_steps, params, finetuning_args)
        self.jsonl = (JsonlLogger(os.path.join(args.output_dir,
                                               "trainer_log.jsonl"))
                      if args.output_dir else None)

    def init_state(self, seed: int) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(step=0, generator=gen)

    def _micro_step(self, state: TrainState, batch) -> Dict[str, Any]:
        t0 = time.perf_counter()
        loss, aux = self.loss_fn(batch, state.generator)
        _sync(self.device)
        t1 = time.perf_counter()
        loss.backward()
        _sync(self.device)
        t2 = time.perf_counter()
        with torch.no_grad():
            gnorm = float(global_norm(p.grad for p in self.params.values()
                                      if p.grad is not None))
        self.optimizer.accumulate()
        for p in self.params.values():
            p.grad = None
        _sync(self.device)
        t3 = time.perf_counter()
        return {"loss": loss.item(), "aux": {k: v.item()
                                             for k, v in aux.items()},
                "grad_norm": gnorm, "forward_s": t1 - t0,
                "backward_s": t2 - t1, "optimizer_s": t3 - t2}

    def train(self, state: TrainState,
              batches: Iterator[Dict[str, np.ndarray]],
              total_micro_steps: int,
              save_fn: Optional[Callable[[TrainState, str], None]] = None,
              log_every: Optional[int] = None,
              eval_fn: Optional[Callable[[TrainState], float]] = None,
              ) -> Tuple[TrainState, Dict[str, Any]]:
        """Micro steps until state.step reaches total_micro_steps (a
        restored step counts toward the budget; the caller feeds batches
        already advanced past the consumed ones)."""
        args = self.args
        log_every = log_every or args.logging_steps
        t0 = time.time()
        losses: List[float] = []
        window: List[float] = []
        step_times: List[Dict[str, float]] = []
        tokens_seen = 0
        if state.step >= total_micro_steps:
            logger.info("checkpoint step %d >= total steps %d: nothing to do",
                        state.step, total_micro_steps)
            return state, {"train_loss": float("nan"),
                           "train_steps": state.step, "train_runtime": 0.0,
                           "step_times": step_times}
        for batch in _prefetch(batches, depth=2):
            if state.step >= total_micro_steps:
                break
            tokens = int(np.asarray(batch["attention_mask"]).sum())
            tokens_seen += tokens
            out = self._micro_step(state, batch)
            state.step += 1
            step_times.append({"tokens": tokens, **{
                k: out[k] for k in ("forward_s", "backward_s",
                                    "optimizer_s")}})
            window.append(out["loss"])
            if not math.isfinite(out["loss"]):
                logger.warning("non-finite loss at step %d", state.step)
            if state.step % log_every == 0:
                losses.extend(window)
                opt_step = state.step // max(args.gradient_accumulation_steps,
                                             1)
                lr = float(self.schedule(opt_step))
                elapsed = time.time() - t0
                rec = {
                    "current_steps": state.step,
                    "total_steps": total_micro_steps,
                    "loss": sum(window) / len(window),
                    "lm_loss": out["aux"]["lm_loss"],
                    "design_loss": out["aux"]["design_loss"],
                    "retro_loss": out["aux"]["retro_loss"],
                    "grad_norm": out["grad_norm"],
                    "learning_rate": lr,
                    "epoch": state.step / max(total_micro_steps, 1)
                    * float(args.num_train_epochs),
                    "throughput_tok_s": tokens_seen / max(elapsed, 1e-9),
                    "elapsed": elapsed,
                }
                window.clear()
                logger.info("step %d/%d loss %.4f lr %.2e %.0f tok/s",
                            state.step, total_micro_steps, rec["loss"], lr,
                            rec["throughput_tok_s"])
                if self.jsonl:
                    self.jsonl.log(rec)
            if (args.output_dir and save_fn and args.save_steps
                    and state.step % args.save_steps == 0):
                save_fn(state, os.path.join(args.output_dir,
                                            f"checkpoint-{state.step}"))
            if (eval_fn is not None and args.eval_strategy == "steps"
                    and args.eval_steps
                    and state.step % args.eval_steps == 0):
                ev = float(eval_fn(state))
                logger.info("step %d eval_loss %.4f", state.step, ev)
                if self.jsonl:
                    self.jsonl.log({"current_steps": state.step,
                                    "total_steps": total_micro_steps,
                                    "eval_loss": ev})
        losses.extend(window)
        metrics = {
            "train_loss": float(np.mean(losses)) if losses else float("nan"),
            "train_steps": state.step,
            "train_runtime": time.time() - t0,
            "step_times": step_times,
        }
        return state, metrics

    # -- checkpointing ------------------------------------------------------
    def save_checkpoint(self, state: TrainState, path: str) -> None:
        """The JAX package's msgpack checkpoint under path:
        trainable.msgpack (the bundle tree), opt_state.msgpack (the
        optimizer's state under the keys of the optax state JAX's
        create_optimizer builds, AdamW or the custom chain) and
        trainer_state.json (step, backend,
        a JAX key derived from the generator, and the generator's own
        state under "torch_generator")."""
        os.makedirs(path, exist_ok=True)
        save_pytree(bundle_tree(self.params),
                    os.path.join(path, "trainable.msgpack"))
        save_state(optax_state(self.optimizer),
                   os.path.join(path, "opt_state.msgpack"))
        gen_state = state.generator.get_state()
        meta = {"step": state.step, "rng": jax_key_data(gen_state),
                "backend": "msgpack",
                "torch_generator": gen_state.tolist()}
        with open(os.path.join(path, "trainer_state.json"), "w") as f:
            json.dump(meta, f)

    @torch.no_grad()
    def load_checkpoint(self, state: TrainState, path: str) -> TrainState:
        """Resume from a checkpoint-N either package wrote. A JAX one has
        no generator state: the generator is seeded from its rng key
        (random draws differ between the packages anyway)."""
        with open(os.path.join(path, "trainer_state.json")) as f:
            meta = json.load(f)
        backend = meta.get("backend", "msgpack")
        if backend != "msgpack":
            raise NotImplementedError(
                f"{path}: {backend} checkpoints are not read by "
                "llamole_tpu_torch (ROADMAP.md Queue 1 item 9: orbax)")
        saved = trainable_values(
            load_pytree(os.path.join(path, "trainable.msgpack")),
            self.params)
        for name, p in self.params.items():
            p.copy_(saved[name])
        load_optax_state(self.optimizer, load_state(
            os.path.join(path, "opt_state.msgpack")))
        if "torch_generator" in meta:
            state.generator.set_state(torch.tensor(meta["torch_generator"],
                                                   dtype=torch.uint8))
        else:
            hi, lo = (int(x) for x in meta["rng"])
            state.generator.manual_seed((hi << 32) | lo)
        state.step = int(meta["step"])
        return state


def jax_key_data(generator_state: torch.Tensor) -> List[int]:
    """A threefry key's data (two uint32) derived from a generator state
    without drawing from it: what JAX's load_checkpoint wraps into its
    rng."""
    digest = hashlib.sha256(generator_state.numpy().tobytes()).digest()
    return [int(x) for x in np.frombuffer(digest[:8], dtype=">u4")]


def optax_state(opt: AccumulatingAdamW) -> Dict[str, Any]:
    """The optimizer's state in the state-dict form of the optax state
    create_optimizer builds: chain(clip_by_global_norm, chain) is
    {"0": {}, "1": opt.chain_state()} (AdamW's or the custom chain's
    parts), wrapped at accumulation k > 1 in MultiStepsState(mini_step,
    gradient_step, inner_opt_state, acc_grads, skip_state). Moments are
    laid out as the bundle tree."""
    inner = {"0": {}, "1": opt.chain_state()}
    if opt.k == 1:
        return inner
    return {"mini_step": int32_scalar(opt.mini_step),
            "gradient_step": int32_scalar(opt.count), "inner_opt_state": inner,
            "acc_grads": bundle_tree(opt.acc), "skip_state": {}}


@torch.no_grad()
def load_optax_state(opt: AccumulatingAdamW, state: Dict[str, Any]) -> None:
    """optax_state's inverse: a state dict of JAX's opt_state.msgpack (or
    the port's) into the optimizer; a state of another accumulation or
    chain, or with unknown or missing leaves, raises."""
    multi = "inner_opt_state" in state
    if multi != (opt.k > 1):
        raise ValueError(f"opt_state is {'' if multi else 'not '}a "
                         f"MultiSteps state; the optimizer accumulates "
                         f"{opt.k} steps")
    inner = state["inner_opt_state"] if multi else state
    if set(inner) != {"0", "1"}:
        raise ValueError(f"opt_state is not chain(clip_by_global_norm, "
                         f"{opt.CHAIN}): keys {sorted(inner)}")
    counts = set(opt.load_chain_state(inner["1"]))
    if multi:
        counts.add(int(state["gradient_step"]))
        load_into(to_state_dict(bundle_tree(opt.acc)), state["acc_grads"],
                   "acc_grads", [])
    if len(counts) != 1:
        raise ValueError(f"opt_state counts disagree: {sorted(counts)}")
    opt.count = counts.pop()
    opt.mini_step = int(state["mini_step"]) if multi else 0
    if not multi:
        for acc in opt.acc.values():
            acc.zero_()


def _prefetch(iterator, depth: int = 2):
    """Collate the next batches on a host thread while the device runs the
    current one. The worker stops when the consumer does (step budget,
    exception), and collation errors re-raise in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(item):
                    return
        except Exception as e:  # noqa: BLE001 -- re-raised in the consumer
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=2.0)


def _checkpoint_complete(d: str) -> bool:
    meta_file = os.path.join(d, "trainer_state.json")
    if not os.path.exists(meta_file):
        return False
    try:
        with open(meta_file) as f:
            backend = json.load(f).get("backend", "msgpack")
    except (OSError, json.JSONDecodeError):
        return False
    if backend == "orbax":   # discovered as JAX does; loading it raises
        return os.path.isdir(os.path.join(d, "orbax_state"))
    return os.path.exists(os.path.join(d, "trainable.msgpack"))


def find_last_checkpoint(output_dir: str) -> Optional[str]:
    """The highest complete checkpoint-N under output_dir, or None."""
    if not output_dir or not os.path.isdir(output_dir):
        return None
    best, best_n = None, -1
    for d in glob.glob(os.path.join(output_dir, "checkpoint-*")):
        m = re.match(r".*checkpoint-(\d+)$", d)
        if m and os.path.isdir(d) and _checkpoint_complete(d):
            n = int(m.group(1))
            if n > best_n:
                best, best_n = d, n
    return best
