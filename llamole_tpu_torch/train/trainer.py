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

Mesh training (`mesh`, the parallel/mesh.py MeshGroups of a DeviceMesh
over dcn / pp / dp / ep / sp / tp, on which the caller placed the model with
parallel/sharding.py shard_graph_lm): one process per rank, all drawing
the same random numbers. The LLM is tensor-parallel over tp (DTensors; a
full-finetune LLM trains sharded), under ZeRO-3 (zero_stage >= 3) its
frozen storage is sharded over dp with FSDP2, and the graph modules and
connectors stay plain replicated tensors (kernels B and C never see a
DTensor). Each batch's per-sequence rows shard over (dcn, dp) when they
divide, else replicate (place_batch); the ranks' losses sum to the
mesh-less loss (GraphLM.loss) and the optimizer sums their gradients
(ZeRO-1 at zero_stage >= 1: reduce-scatter, shard-local update,
all-gather; train/optimizers.py). Only rank 0 writes files. The msgpack
checkpoints hold whole tensors (gathered), so a run resumes across
packages and meshes; under LLAMOLE_ORBAX=1 the state is written sharded
with torch.distributed.checkpoint's async_save into dcp_state/
("backend": "dcp"), wait_for_checkpoints() being the barrier. A JAX orbax
checkpoint raises: its format needs orbax / tensorstore. With a pp axis
(the model pipelined: GraphLM.enable_pipeline) each stage trains its own
layers' leaves, the replicated ones are summed over pp as well, the
batch's rows shard over dp only when the microbatch rows divide (else
they replicate, as JAX's pipeline does), a msgpack checkpoint gathers
every stage's part for rank 0 and a resume keeps this stage's leaves of
it, and a DCP checkpoint has each stage write and read its own leaves
and their optimizer state. An MoE LLM's experts split over ep
(shard_graph_lm, as JAX's _ep_axis places them); the ranks along ep and
sp hold the same rows (place_batch shards over (dcn, dp) only).
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

from .optimizers import (AccumulatingAdamW, create_optimizer, int32_scalar,
                         load_into, local_data)

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
        """params: the trainable bundle (GraphLM.trainable_parameters(),
        read after the model's placement on a mesh); num_training_steps
        counts optimizer updates. mesh: the MeshGroups (parallel.mesh) of
        the DeviceMesh the model was placed on."""
        self.groups = mesh
        if not params:
            raise ValueError("no trainable parameters")
        if mesh is not None:
            from ..parallel.pipeline import check_pipeline_zero
            check_pipeline_zero(mesh.size, getattr(args, "zero_stage", 0))
        self.loss_fn = loss_fn
        self.params = params
        self.args = args
        self.device = local_data(next(iter(params.values()))).device
        self.num_training_steps = num_training_steps
        self.optimizer, self.schedule = create_optimizer(
            args, num_training_steps, params, finetuning_args,
            groups=self.groups,
            zero1=getattr(args, "zero_stage", 0) >= 1)
        self.writer = self.groups is None or torch.distributed.get_rank() == 0
        self.jsonl = (JsonlLogger(os.path.join(args.output_dir,
                                               "trainer_log.jsonl"))
                      if args.output_dir and self.writer else None)
        self._pending = None      # an async DCP save in flight
        self._dcp_group = None

    # per-sequence arrays shard over (dcn, dp); graph banks replicate
    # (their row indices span the whole batch)
    _PER_SEQ = ("input_ids", "attention_mask", "labels",
                "molecule_properties", "design_graph_index",
                "design_start_pos")

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """A collated batch as this rank computes it: on a mesh the rows
        of its (dcn, dp) coordinate of every per-sequence key when they
        divide, else all of them, with "row_shard" = [offset, rows]."""
        if self.groups is None:
            return batch
        from ..parallel.pipeline import data_rows
        gr = self.groups
        rows = np.asarray(batch["input_ids"]).shape[0]
        off, per = data_rows(rows, gr, max(self.args.pipeline_microbatches,
                                           1) if gr.pp > 1 else None)
        out = {k: (np.asarray(v)[off:off + per] if k in self._PER_SEQ else v)
               for k, v in batch.items()}
        out["row_shard"] = np.asarray([off, rows], np.int64)
        return out

    def _data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A loss value summed over the data group (the ranks' parts of
        the mesh-less value); as it is without a mesh."""
        if self.groups is None:
            return t.detach()
        from ..parallel.comm import all_reduce_
        out = all_reduce_(t.detach().float().clone(), self.groups.data_group)
        if self.groups.pp > 1:     # and the pp ranks' shares
            all_reduce_(out, self.groups.pp_group)
        return out

    def init_state(self, seed: int) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(step=0, generator=gen)

    def _micro_step(self, state: TrainState, batch) -> Dict[str, Any]:
        t0 = time.perf_counter()
        loss, aux = self.loss_fn(self.place_batch(batch), state.generator)
        _sync(self.device)
        t1 = time.perf_counter()
        loss.backward()
        _sync(self.device)
        t2 = time.perf_counter()
        self.optimizer.accumulate()
        for p in self.params.values():
            p.grad = None
        _sync(self.device)
        t3 = time.perf_counter()
        return {"loss": self._data_sum(loss).item(),
                "aux": {k: self._data_sum(v).item() for k, v in aux.items()},
                "grad_norm": self.optimizer.last_grad_norm,
                "forward_s": t1 - t0, "backward_s": t2 - t1,
                "optimizer_s": t3 - t2}

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
        self.wait_for_checkpoints()   # async DCP saves commit before exit
        metrics = {
            "train_loss": float(np.mean(losses)) if losses else float("nan"),
            "train_steps": state.step,
            "train_runtime": time.time() - t0,
            "step_times": step_times,
        }
        return state, metrics

    # -- checkpointing ------------------------------------------------------
    def _use_dcp(self) -> bool:
        """LLAMOLE_ORBAX=1: the JAX package's switch to orbax, here
        torch.distributed.checkpoint."""
        return bool(os.environ.get("LLAMOLE_ORBAX"))

    def _pipelined(self) -> bool:
        return self.groups is not None and self.groups.pp > 1

    def wait_for_checkpoints(self) -> None:
        """Block until the async DCP save in flight has committed."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _dcp_kwargs(self) -> Dict[str, Any]:
        """DCP's coordination group: a gloo group of every rank of its
        own (made once). async_save stages on the host, so its group must
        be CPU-capable, and it exchanges its plan and metadata on a
        thread while training goes on: on the default group (which a
        mesh axis spanning the world also uses) the two threads'
        collectives would interleave and deadlock."""
        if self.groups is None:
            return {}
        if self._dcp_group is None:
            self._dcp_group = torch.distributed.new_group(backend="gloo")
        return {"process_group": self._dcp_group}

    def _dcp_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The parameters and the optimizer's whole state (GaLore's bases
        among it), each rank's parts as DTensors on the whole mesh (the
        axes that shard a part place it: tp or ep as the parameter, dp
        for a ZeRO-1 chunk or a GaLore moment's part; the others
        replicate), so DCP writes each distinct part once; plain tensors
        without a mesh. Beside pp each rank holds its stage's leaves, and
        writes and reads those. Scalars go to trainer_state.json."""
        opt = self.optimizer
        state = {"params": {n: local_data(p).detach()
                            for n, p in self.params.items()}}
        for k in opt.STATE + opt.EXTRA_STATE:
            if getattr(opt, k):
                state[k] = dict(getattr(opt, k))
        if self.groups is None:
            return state
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = self.groups.mesh
        axes = list(mesh.mesh_dim_names)
        low_rank = getattr(opt, "galore_names", ())

        def on_mesh(key, name, t):
            p = self.params[name]
            pl = [Replicate()] * mesh.ndim
            shape = list(t.shape)
            if key in ("mu", "nu") and name in low_rank:
                side = opt._moment_side(name)
                if side is not None:
                    dim, (_, size, _, axis) = side
                    pl[axes.index(axis)] = Shard(dim)
                    shape[dim] *= size
            elif key != "proj":
                if isinstance(p, DTensor):
                    for axis, ppl in zip(p.device_mesh.mesh_dim_names,
                                         p.placements):
                        pl[axes.index(axis)] = ppl
                d = opt.shard_dim.get(name) if key != "params" else None
                if d is not None:
                    pl[axes.index("dp")] = Shard(d)
                shape = list(p.shape)
            return DTensor.from_local(
                t.detach(), mesh, pl, run_check=False,
                shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
        return {k: {n: on_mesh(k, n, t) for n, t in v.items()}
                for k, v in state.items()}

    def save_checkpoint(self, state: TrainState, path: str) -> None:
        """The JAX package's checkpoint under path: trainable.msgpack (the
        bundle tree), opt_state.msgpack (the optimizer's state under the
        keys of the optax state JAX's create_optimizer builds, AdamW or
        the custom chain) and trainer_state.json (step, backend, a JAX
        key derived from the generator, the generator's own state under
        "torch_generator", and under DCP the optimizer's counters). On a
        mesh every rank calls it (the tensors are gathered) and rank 0
        writes. Under LLAMOLE_ORBAX=1 the parameters and the optimizer's
        state go sharded to dcp_state/ by an async DCP save instead; the
        previous one is waited for first."""
        from ..parallel.sharding import full
        if self.writer:
            os.makedirs(path, exist_ok=True)
        meta = {"step": state.step}
        if self._use_dcp():
            import torch.distributed.checkpoint as dcp
            self.wait_for_checkpoints()
            opt = self.optimizer
            meta.update(backend="dcp", count=opt.count,
                        mini_step=opt.mini_step,
                        chain=type(opt).__name__)
            self._pending = dcp.async_save(
                self._dcp_state(),
                checkpoint_id=os.path.join(os.path.abspath(path),
                                           "dcp_state"),
                **self._dcp_kwargs())
        else:
            values = {n: full(p) for n, p in self.params.items()}
            if self._pipelined():
                from ..parallel.pipeline import gather_stage_dicts
                values = gather_stage_dicts(values, self.groups)
            with self.optimizer.whole_state():
                opt_state = optax_state(self.optimizer)
                if self.writer:
                    save_pytree(bundle_tree(values),
                                os.path.join(path, "trainable.msgpack"))
                    save_state(opt_state,
                               os.path.join(path, "opt_state.msgpack"))
            meta["backend"] = "msgpack"
        gen_state = state.generator.get_state()
        meta.update(rng=jax_key_data(gen_state),
                    torch_generator=gen_state.tolist())
        if self.writer:
            with open(os.path.join(path, "trainer_state.json"), "w") as f:
                json.dump(meta, f)

    @torch.no_grad()
    def load_checkpoint(self, state: TrainState, path: str) -> TrainState:
        """Resume from a checkpoint-N either package wrote (msgpack), or
        this package's DCP one. A JAX one has no generator state: the
        generator is seeded from its rng key (random draws differ
        between the packages anyway). On a mesh every rank reads the
        whole tensors and keeps its parts. A JAX orbax checkpoint raises:
        its format needs orbax / tensorstore, which the port does not
        use."""
        from ..parallel.sharding import local
        with open(os.path.join(path, "trainer_state.json")) as f:
            meta = json.load(f)
        backend = meta.get("backend", "msgpack")
        opt = self.optimizer
        if backend == "dcp":
            import torch.distributed.checkpoint as dcp
            self.wait_for_checkpoints()
            if meta.get("chain") != type(opt).__name__:
                raise ValueError(f"{path}: a {meta.get('chain')} state, the "
                                 f"optimizer is {type(opt).__name__}")
            target = self._dcp_state()
            dcp.load(target, checkpoint_id=os.path.join(
                os.path.abspath(path), "dcp_state"), **self._dcp_kwargs())
            mine = self._dcp_state()
            for k, part in target.items():
                for n, t in part.items():
                    local_data(mine[k][n]).copy_(local(t))
            opt.count, opt.mini_step = int(meta["count"]), int(
                meta["mini_step"])
        elif backend != "msgpack":
            raise NotImplementedError(
                f"{path}: {backend} checkpoints are not read by "
                "llamole_tpu_torch (the JAX package's orbax format needs "
                "orbax / tensorstore; the port's sharded checkpoints are "
                "DCP, backend \"dcp\")")
        else:
            # every stage's leaves are in the file: this rank keeps its own
            saved = trainable_values(
                load_pytree(os.path.join(path, "trainable.msgpack")),
                opt.all_names)
            for name, p in self.params.items():
                local_data(p).copy_(opt._part(name, saved[name],
                                              zero1=False))
            with opt.whole_state(load=True):
                load_optax_state(opt, load_state(
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
    if backend == "dcp":     # DCP writes .metadata when the save commits
        return os.path.exists(os.path.join(d, "dcp_state", ".metadata"))
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
