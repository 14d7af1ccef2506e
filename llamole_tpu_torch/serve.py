"""Batch serving for molecular design and retrosynthesis (counterpart of
llamole_tpu/serve.py DesignServer / serve_stream / serve_jsonl).

A request queue and a scheduler thread assemble fixed-size batches:
requests accumulate until `batch_size` wait or the oldest has waited
`max_wait_s`; each flush pads the batch to exactly `batch_size` rows by
repeating the last request, left-pads prompts to a shared 64-multiple,
and runs GraphLM.design_molecule once. Design-only rows are answered at
once; the rows that asked for "retro" then share ONE interleaved Retro*
search (GraphLM.retrosynthesize_batch) over their designed molecules.

Request (JSONL line / submit kwargs):
  {"prompt": str, "property": {name: value, ...}, "retro": bool}
  {"stats": true} answers inline with the serving counters, latency
  percentiles and, under "counters", the program's counters
  (utils/profiling.py: serve.*, design.*, llm.*, graphdit.*, assemble.*).
Result:
  {"id": n, "text": str, "smiles": str | null, "latency_s": float,
   "retro": {"success": bool, "reactions": [...], "templates": [...],
             "cost": [...]}}        # "retro" only when requested

    python -m llamole_tpu_torch.serve <config.yaml> [--device cuda|cpu] \
        < requests.jsonl
    python -m llamole_tpu_torch.serve <config.yaml> --tcp [PORT] \
        [--host 127.0.0.1] [--device cuda|cpu]

With `continuous_batching: true` in the config, ContinuousDesignServer
serves instead: the analysis decode runs in a slot pool
(models/gllm/continuous.py), design groups on a second thread and retro
searches on a third.
"""

import argparse
import json
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .utils import profiling
from .utils.constants import MOL_PROPERTIES
from .utils.logging import get_logger

from .models.composite import GenerationSettings

logger = get_logger(__name__)

@dataclass
class _Pending:
    prompt_ids: List[int]
    properties: np.ndarray
    retro: bool = False
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    t_submit: float = field(default_factory=time.monotonic)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def resolve(self, result: Dict[str, Any]) -> Optional[float]:
        """Set the result (stamped with its latency) and wake the waiter,
        once: a worker and stop() may race to answer one request, and the
        first wins. Returns the latency, or None when already answered."""
        with self._lock:
            if self.event.is_set():
                return None
            latency = time.monotonic() - self.t_submit
            result["latency_s"] = round(latency, 4)
            self.result = result
            self.event.set()
        return latency


class _LatencyStats:
    """Rolling window of request latencies."""

    def __init__(self, window: int = 512):
        self._window = window
        self._lat: List[float] = []
        self._lock = threading.Lock()

    def record(self, latency: float) -> None:
        with self._lock:
            self._lat.append(latency)
            if len(self._lat) > self._window:
                del self._lat[:-self._window]

    def summary(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._lat)
        if not lat:
            return {}

        def pick(q):
            return lat[min(int(q * len(lat)), len(lat) - 1)]

        return {"latency_p50_s": round(pick(0.50), 4),
                "latency_p95_s": round(pick(0.95), 4),
                "latency_max_s": round(lat[-1], 4)}


class DesignHandle:
    """Future-like handle for one submitted request."""

    def __init__(self, pending: _Pending):
        self._p = pending

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._p.event.wait(timeout):
            raise TimeoutError("design request not completed in time")
        return self._p.result


def properties_vector(prop: Optional[Dict[str, float]]) -> np.ndarray:
    """10-dim conditioning vector; absent channels NaN."""
    vec = np.full(len(MOL_PROPERTIES), np.nan, np.float32)
    for name, value in (prop or {}).items():
        if name not in MOL_PROPERTIES:
            raise ValueError(f"unknown property {name!r}; expected one of "
                             f"{list(MOL_PROPERTIES)}")
        vec[MOL_PROPERTIES.index(name)] = float(value)
    return vec


def _retro_payload(plan: Dict[str, Any]) -> Dict[str, Any]:
    """The result's "retro" block from a planner result ({} = no plan)."""
    return {"success": bool(plan.get("success")),
            "reactions": list(plan.get("reaction_list") or []),
            "templates": list(plan.get("templates") or []),
            "cost": [float(c) for c in (plan.get("cost") or [])]}


class _DesignServerBase:
    """Request-side plumbing of both servers: submission (with stop()'s
    race), the counters and latency stats, error resolution and queue
    draining. Subclasses hold tokenizer, _queue, _stop, _lat,
    batches_run and requests_served, and run the scheduler."""

    def submit(self, prompt: str,
               properties: Optional[Dict[str, float]] = None,
               retro: bool = False) -> DesignHandle:
        pending = _Pending(prompt_ids=self.tokenizer.encode(prompt),
                           properties=properties_vector(properties),
                           retro=bool(retro))
        if self._stop.is_set():
            pending.resolve({"text": "", "smiles": None,
                             "error": "server stopped"})
        else:
            self._queue.put(pending)
            if self._stop.is_set():   # raced stop()'s drain
                self._drain_queue(self._queue)
        return DesignHandle(pending)

    def stats(self) -> Dict[str, Any]:
        """Serving counters + rolling latency percentiles, and the
        program's counters (utils/profiling.py) under "counters"."""
        return {"requests_served": self.requests_served,
                "batches_run": self.batches_run, **self._extra_stats(),
                **self._lat.summary(), "counters": profiling.counters()}

    def _extra_stats(self) -> Dict[str, Any]:
        return {}

    def _resolve(self, p: _Pending, result: Dict[str, Any]) -> None:
        latency = p.resolve(result)
        if latency is not None:
            self._lat.record(latency)

    def _resolve_error(self, p: _Pending, msg: str) -> None:
        """Answer p with an error, unless it was answered already."""
        self._resolve(p, {"text": "", "smiles": None, "error": msg})

    def _drain_queue(self, q: "queue.Queue",
                     extract=lambda item: (item,)) -> None:
        """Empty q, answering every request its items hold as stopped."""
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                return
            for p in extract(item):
                self._resolve_error(p, "server stopped")


class DesignServer(_DesignServerBase):
    """Batching scheduler over GraphLM.design_molecule, with one
    retrosynthesize_batch per batch for the rows that ask for a route
    (retro_topk / retro_iterations / retro_max_time / retro_width are its
    expansion top-k, per-molecule iteration cap, shared planning wall and
    frontier width)."""

    def __init__(self, model, tokenizer, *, batch_size: int = 8,
                 max_wait_s: float = 0.05,
                 gen: GenerationSettings = GenerationSettings(),
                 rollback: bool = True, seed: int = 0,
                 retro_topk: int = 50, retro_iterations: int = 100,
                 retro_max_time: float = 30.0, retro_width: int = 8):
        self.model = model
        self.tokenizer = tokenizer
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_s)
        self.gen = gen
        self.rollback = rollback
        self.retro_topk = retro_topk
        self.retro_iterations = retro_iterations
        self.retro_max_time = retro_max_time
        self.retro_width = retro_width
        self._generator = torch.Generator(device=model.device).manual_seed(
            seed)
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.batches_run = 0
        self.requests_served = 0
        self._lat = _LatencyStats()

    def start(self) -> "DesignServer":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        self._drain_queue(self._queue)

    def _gather(self) -> List[_Pending]:
        """Block for the first request, then fill the batch until full or
        the max-wait deadline passes."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._gather()
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # a bad batch must not kill the server
                logger.exception("design batch failed: %s", e)
                for p in batch:
                    # design-only rows answered before the retro phase
                    # keep their results
                    self._resolve_error(p, str(e))

    def _run_batch(self, batch: List[_Pending]) -> None:
        n_real = len(batch)
        t_start = time.monotonic()
        profiling.count("serve.requests", n_real)
        profiling.add("serve.queue_wait_s",
                      sum(t_start - p.t_submit for p in batch))
        profiling.count("serve.rows_real", n_real)
        profiling.count("serve.rows_run", self.batch_size)
        with profiling.batch("serve.batch", self.batches_run):
            self._design_batch(batch)
        self.batches_run += 1
        self.requests_served += n_real

    def _design_batch(self, batch: List[_Pending]) -> None:
        n_real = len(batch)
        rows = batch + [batch[-1]] * (self.batch_size - n_real)
        ids, mask = self.model._left_pad([p.prompt_ids for p in rows])
        props = np.stack([p.properties for p in rows])
        analysis, smiles = self.model.design_molecule(
            ids, mask, props, gen=self.gen, rollback=self.rollback,
            generator=self._generator)
        # design-only rows are answered at once, not after the (possibly
        # long) retro search of the rows batched with them
        retro_rows = []
        with profiling.span("serve.respond"):
            for i, p in enumerate(batch):
                text = self.tokenizer.decode(
                    self.model._strip_pads(analysis[i]),
                    skip_special_tokens=True)
                result = {"text": text, "smiles": smiles[i]}
                if p.retro and smiles[i] is not None:
                    p.result = result   # answered after the retro phase
                    retro_rows.append((i, p))
                    continue
                if p.retro:   # nothing designed to plan for
                    result["retro"] = _retro_payload({})
                self._resolve(p, result)
        if retro_rows:
            plans = self.model.retrosynthesize_batch(
                [smiles[i] for i, _ in retro_rows],
                generator=self._generator, expansion_topk=self.retro_topk,
                iterations=self.retro_iterations,
                max_planning_time=self.retro_max_time, rollback=False,
                gen=self.gen, total_width=self.retro_width)
            for i, p in retro_rows:
                p.result["retro"] = _retro_payload(plans.get(smiles[i], {}))
                self._resolve(p, p.result)


class ContinuousDesignServer(_DesignServerBase):
    """Continuous (in-flight) batched design serving.

    The analysis decode streams through a SlotDecoder pool
    (models/gllm/continuous.py): a request joins the running pool at the
    next chunk boundary and a finished row frees its slot at once. The
    scheduler thread admits, decodes and hands completed analyses to a
    design worker in groups of `design_batch` (padded by repeating the
    last row; GraphLM.design_from_analysis with true_b = the real rows),
    which answers design-only requests at once and hands the group's
    retro rows to a retro worker: one retrosynthesize_batch per group.
    So no request queues behind another group's retro search, and the
    decode is issued while GraphDiT samples and Retro* searches. The three
    stages are host-bound Python loops, and each runs slower beside
    another: on an H100 this server has answered slower than DesignServer
    on the same requests (PERF.md). A stage that fails answers its
    requests with an "error". The design
    and retro queues are bounded: a slow stage fills its queue, the
    scheduler stops flushing and then admitting, and requests wait at
    submission.

    Same submit() / DesignHandle surface and result schema as
    DesignServer (GeneratingArguments continuous_batching: true picks
    it). The three threads share the model; each stage keeps its own
    torch.Generator, and the adapter switch of value scoring
    (LLM.adapter_disabled) holds for the retro worker's thread alone."""

    def __init__(self, model, tokenizer, *, slots: int = 8,
                 chunk_steps: int = 8, design_batch: int = 8,
                 max_wait_s: float = 0.05, cache_len: int = 1024,
                 prompt_buckets=(64, 128, 256, 512),
                 gen: GenerationSettings = GenerationSettings(),
                 rollback: bool = True, seed: int = 0,
                 shared_prefix_text: Optional[str] = None,
                 retro_topk: int = 50, retro_iterations: int = 100,
                 retro_max_time: float = 30.0, retro_width: int = 8):
        from .models.gllm.continuous import SlotDecoder

        if gen.repetition_penalty != 1.0:
            # the slot pool keeps no per-row seen-token state across slot
            # reuse; refusing beats decoding unlike DesignServer
            raise ValueError(
                "continuous batching does not support repetition_penalty"
                " != 1.0: use the full-batch DesignServer")
        self.model = model
        self.tokenizer = tokenizer
        self.design_batch = int(design_batch)
        self.max_wait_s = float(max_wait_s)
        self.gen = gen
        self.rollback = rollback
        self.retro_topk = retro_topk
        self.retro_iterations = retro_iterations
        self.retro_max_time = retro_max_time
        self.retro_width = retro_width
        prefix_ids = (tokenizer.encode(shared_prefix_text)
                      if shared_prefix_text else None)
        # drop the buckets a small cache_len cannot hold (with the prefix)
        # rather than refuse the server
        budget = cache_len - gen.max_new_tokens - len(prefix_ids or ())
        fitting = tuple(b for b in prompt_buckets if b <= budget)
        self.decoder = SlotDecoder(
            model.llm, slots=slots, cache_len=cache_len,
            max_new_tokens=gen.max_new_tokens, eos_ids=model._eos_ids(),
            pad_id=tokenizer.pad_token_id, temperature=gen.temperature,
            top_p=gen.top_p, top_k=gen.top_k, do_sample=gen.do_sample,
            chunk_steps=chunk_steps,
            prompt_buckets=fitting or tuple(prompt_buckets),
            shared_prefix=prefix_ids, seed=seed)
        self._design_gen = torch.Generator(
            device=model.device).manual_seed(seed + 1)
        self._retro_gen = torch.Generator(
            device=model.device).manual_seed(seed + 2)
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._rid_pending: Dict[int, _Pending] = {}
        self._ready: List[tuple] = []   # (deadline, pending, tokens)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._design_queue: "queue.Queue[list]" = queue.Queue(maxsize=4)
        self._retro_queue: "queue.Queue[list]" = queue.Queue(maxsize=8)
        self.batches_run = 0
        self.requests_served = 0
        self._lat = _LatencyStats()

    def _extra_stats(self) -> Dict[str, Any]:
        return {"decode_chunks_run": self.decoder.chunks_run}

    def _put_stop_aware(self, q: "queue.Queue", item) -> bool:
        """Blocking put that gives up once the server stops (a full queue
        whose consumer has exited must not wedge a worker); False when
        the item was not enqueued."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def start(self) -> "ContinuousDesignServer":
        for target in (self._loop, self._design_loop, self._retro_loop):
            th = threading.Thread(target=target, daemon=True)
            th.start()
            self._threads.append(th)
        return self

    def stop(self) -> None:
        """Stop the three threads and answer everything in flight with
        "server stopped" (queued, decoding, waiting for a design group or
        for a retro search)."""
        self._stop.set()
        for th in self._threads:
            th.join(timeout=60)
        # a stage that outlived its join (a long search iteration) can
        # still hand work on after the drain: sweep until every worker
        # is gone, so no waiter hangs on a stopped server
        deadline = time.monotonic() + 60
        self._drain_in_flight()
        while (any(th.is_alive() for th in self._threads)
               and time.monotonic() < deadline):
            time.sleep(0.1)
            self._drain_in_flight()
        self._drain_in_flight()

    def _drain_in_flight(self) -> None:
        for p in list(self._rid_pending.values()):
            self._resolve_error(p, "server stopped")
        self._rid_pending.clear()
        for _, p, _t in self._ready:
            self._resolve_error(p, "server stopped")
        self._ready.clear()
        self._drain_queue(self._queue)
        self._drain_queue(self._design_queue,
                          extract=lambda group: [p for p, _t in group])
        self._drain_queue(self._retro_queue,
                          extract=lambda rows: [p for p, _s, _r in rows])

    # -- scheduler thread ------------------------------------------------
    def _loop(self) -> None:
        with torch.no_grad():   # grad mode is per thread
            while not self._stop.is_set():
                if not self._schedule_once():
                    time.sleep(0.005)

    def _schedule_once(self) -> bool:
        """Admit, decode one chunk, flush a design group. True when
        anything moved."""
        moved = False
        # admit unless the completed-analysis backlog says downstream is
        # saturated (requests then wait in the submission queue)
        while len(self._ready) < 4 * self.design_batch:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            try:
                rid = self.decoder.submit(p.prompt_ids)
            except ValueError as e:   # a prompt past every bucket
                self._resolve_error(p, str(e))
            else:
                self._rid_pending[rid] = p
            moved = True
        if not self.decoder.idle:
            try:
                for rid, toks, _trig in self.decoder.step():
                    pending = self._rid_pending.pop(rid, None)
                    if pending is not None:   # None: answered already
                        self._ready.append(
                            (time.monotonic() + self.max_wait_s, pending,
                             toks))
                        moved = True
            except Exception as e:   # a failed decode must not end serving
                logger.exception("continuous decode failed: %s", e)
                for p in self._rid_pending.values():
                    self._resolve_error(p, str(e))
                self._rid_pending.clear()
        flush = ((len(self._ready) >= self.design_batch
                  or (self._ready
                      and (self._ready[0][0] <= time.monotonic()
                           or (self.decoder.idle and self._queue.empty()))))
                 # never block the scheduler on a full design queue
                 and not self._design_queue.full())
        if flush:
            group = self._ready[:self.design_batch]
            self._ready = self._ready[self.design_batch:]
            if not self._put_stop_aware(self._design_queue,
                                        [(p, t) for _, p, t in group]):
                for _, p, _t in group:
                    self._resolve_error(p, "server stopped")
            moved = True
        return moved

    # -- design worker -----------------------------------------------------
    def _design_loop(self) -> None:
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    group = self._design_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                try:
                    self._run_design(group)
                except Exception as e:   # a bad group must not end the worker
                    logger.exception("design stage failed: %s", e)
                    for p, _t in group:
                        self._resolve_error(p, str(e))

    def _run_design(self, rows) -> None:
        """The post-decode stages for a group of completed analyses,
        padded to design_batch rows."""
        n_real = len(rows)
        padded = rows + [rows[-1]] * (self.design_batch - n_real)
        smiles = self.model.design_from_analysis(
            self._design_gen, [p.prompt_ids for p, _ in padded],
            [list(map(int, t)) for _, t in padded],
            np.stack([p.properties for p, _ in padded]), gen=self.gen,
            rollback=self.rollback, true_b=n_real)
        retro_rows = []
        for i, (p, toks) in enumerate(rows):
            result = {"text": self.tokenizer.decode(
                list(map(int, toks)), skip_special_tokens=True),
                "smiles": smiles[i]}
            if p.retro and smiles[i] is not None:
                # answered after the retro search
                retro_rows.append((p, smiles[i], result))
                continue
            if p.retro:   # nothing designed to plan for
                result["retro"] = _retro_payload({})
            self._resolve(p, result)
        # the search goes to the retro worker; this one goes back to
        # sampling the next group
        if retro_rows and not self._put_stop_aware(self._retro_queue,
                                                   retro_rows):
            for p, _smi, result in retro_rows:   # the design; no route
                self._resolve(p, {**result, "retro": _retro_payload({}),
                                  "error": "server stopped before "
                                           "retrosynthesis"})
        self.batches_run += 1
        self.requests_served += n_real

    # -- retro worker ------------------------------------------------------
    def _retro_loop(self) -> None:
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    retro_rows = self._retro_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
                try:
                    plans = self.model.retrosynthesize_batch(
                        [smi for _, smi, _r in retro_rows],
                        generator=self._retro_gen,
                        expansion_topk=self.retro_topk,
                        iterations=self.retro_iterations,
                        max_planning_time=self.retro_max_time,
                        rollback=False, gen=self.gen,
                        total_width=self.retro_width)
                except Exception as e:   # a bad search must not end it
                    logger.exception("retro search failed: %s", e)
                    for p, _smi, result in retro_rows:   # the design; no route
                        self._resolve(p, {**result,
                                          "retro": _retro_payload({}),
                                          "error": str(e)})
                    continue
                for p, smi, result in retro_rows:
                    self._resolve(p, {**result, "retro": _retro_payload(
                        plans.get(smi, {}))})


def serve_stream(server, in_stream, out_stream,
                 join_timeout: float = 600.0) -> None:
    """Drive one JSONL request/response stream against a running server.
    Answers come in completion order with "id" = the input line number;
    a blank line or EOF ends the stream."""
    lock = threading.Lock()
    threads: List[threading.Thread] = []

    def write(obj) -> None:
        with lock:
            out_stream.write(json.dumps(obj) + "\n")
            out_stream.flush()

    def respond(req_id: int, handle: DesignHandle) -> None:
        result = handle.result()
        result["id"] = req_id
        write(result)

    for n, line in enumerate(in_stream):
        line = line.strip()
        if not line:
            break
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError(
                    f"expected a JSON object, got {type(req).__name__}")
            if req.get("stats") is True:   # strict bool, like 'retro'
                write({"id": n, **server.stats()})
                continue
            retro = req.get("retro", False)
            if not isinstance(retro, bool):
                raise ValueError(f"'retro' must be a JSON boolean, got "
                                 f"{retro!r}")
            handle = server.submit(req["prompt"], req.get("property"),
                                   retro=retro)
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            write({"id": n, "error": f"bad request: {e}"})
            continue
        t = threading.Thread(target=respond, args=(n, handle), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=join_timeout)


def resolve_device(device) -> torch.device:
    """The serving device, as asked: a CUDA device without a card raises
    (no silent CPU fallback); "cpu" must be asked for explicitly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was asked for but CUDA is not available; "
            "pass device='cpu' (--device cpu) to serve on the CPU")
    return device


def _build_server(config_path, device="cuda"):
    """Config YAML (or dict) -> a started server on `device`:
    ContinuousDesignServer with continuous_batching, else DesignServer
    (shared by the stdio and TCP entry points). The YAML is read by
    config/ through utils/flat_yaml.py."""
    device = resolve_device(device)
    from .config import get_infer_args

    from .models.loader import build_graph_lm

    model_args, data_args, _training_args, finetuning_args, ga = \
        get_infer_args(config_path)
    model, tok = build_graph_lm(
        model_args, data_args, finetuning_args, device=device,
        generate_mode=True, load_adapter=bool(model_args.adapter_name_or_path))
    gen = GenerationSettings(
        max_new_tokens=ga.max_new_tokens, temperature=ga.temperature,
        top_p=ga.top_p, top_k=ga.top_k, do_sample=ga.do_sample,
        repetition_penalty=ga.repetition_penalty,
        speculative_tokens=ga.speculative_tokens,
        speculative_ngram=ga.speculative_ngram)
    if ga.continuous_batching:
        # serve_batch_size is both the slot count and the design group
        return ContinuousDesignServer(
            model, tok, gen=gen, slots=ga.serve_batch_size,
            design_batch=ga.serve_batch_size,
            chunk_steps=ga.serve_chunk_steps, cache_len=ga.serve_cache_len,
            max_wait_s=ga.serve_max_wait_s,
            shared_prefix_text=ga.shared_prefix_text).start()
    return DesignServer(model, tok, gen=gen, batch_size=ga.serve_batch_size,
                        max_wait_s=ga.serve_max_wait_s).start()


def serve_jsonl(config_path: Optional[str] = None, in_stream=None,
                out_stream=None, device="cuda") -> None:
    """JSONL stdin/stdout serving loop on `device` (default the card;
    without one it raises unless device="cpu")."""
    server = _build_server(config_path, device)
    try:
        serve_stream(server, in_stream or sys.stdin, out_stream or sys.stdout)
    finally:
        server.stop()


def make_tcp_server(server, host: str = "127.0.0.1", port: int = 7733):
    """A ThreadingTCPServer whose every connection speaks the JSONL
    protocol to ONE shared design server, so concurrent clients' requests
    batch together on the card. The caller runs serve_forever() and
    shutdown(); port 0 takes a free one (see server_address)."""
    import io
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            rin = io.TextIOWrapper(self.rfile, encoding="utf-8")
            rout = io.TextIOWrapper(self.wfile, encoding="utf-8",
                                    write_through=True)
            try:
                serve_stream(server, rin, rout)
            except (BrokenPipeError, ConnectionResetError):
                pass   # the client left; its submitted work completes

    class _TCP(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    return _TCP((host, port), Handler)


def serve_tcp(config_path: Optional[str] = None, *, host: str = "127.0.0.1",
              port: int = 7733, device="cuda") -> None:
    """The JSONL protocol over TCP on `device`: one model, one batching
    server, many clients."""
    server = _build_server(config_path, device)
    tcp = make_tcp_server(server, host, port)
    logger.info("serving JSONL over tcp://%s:%d", *tcp.server_address)
    try:
        tcp.serve_forever()
    finally:
        tcp.server_close()
        server.stop()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m llamole_tpu_torch.serve",
        description="JSONL design / retrosynthesis serving on stdin/stdout "
                    "or over TCP")
    ap.add_argument("config", nargs="?", default=None,
                    help="inference YAML (config/args.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to serve "
                         "without a card)")
    ap.add_argument("--tcp", nargs="?", type=int, const=7733, default=None,
                    metavar="PORT",
                    help="serve JSONL over TCP on PORT (default 7733) "
                         "instead of stdin/stdout")
    ap.add_argument("--host", default="127.0.0.1",
                    help="TCP bind address (with --tcp)")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.tcp is not None:
        serve_tcp(args.config, host=args.host, port=args.tcp,
                  device=args.device)
    else:
        serve_jsonl(args.config, device=args.device)


if __name__ == "__main__":
    main()
