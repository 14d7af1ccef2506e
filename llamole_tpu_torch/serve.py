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
  {"stats": true} answers inline with the serving counters and latency
  percentiles.
Result:
  {"id": n, "text": str, "smiles": str | null, "latency_s": float,
   "retro": {"success": bool, "reactions": [...], "templates": [...],
             "cost": [...]}}        # "retro" only when requested

    python -m llamole_tpu_torch.serve <config.yaml> [--device cuda|cpu] \
        < requests.jsonl
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

    def resolve(self, result: Dict[str, Any]) -> float:
        """Set the result (stamped with its latency), wake the waiter."""
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


class DesignServer:
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
                self._drain()
        return DesignHandle(pending)

    def stats(self) -> Dict[str, Any]:
        """Serving counters + rolling latency percentiles."""
        return {"requests_served": self.requests_served,
                "batches_run": self.batches_run, **self._lat.summary()}

    def _resolve(self, p: _Pending, result: Dict[str, Any]) -> None:
        self._lat.record(p.resolve(result))

    def start(self) -> "DesignServer":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
        self._drain()

    def _drain(self) -> None:
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                return
            if not p.event.is_set():
                self._resolve(p, {"text": "", "smiles": None,
                                  "error": "server stopped"})

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
                    if not p.event.is_set():
                        self._resolve(p, {"text": "", "smiles": None,
                                          "error": str(e)})

    def _run_batch(self, batch: List[_Pending]) -> None:
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
        for i, p in enumerate(batch):
            text = self.tokenizer.decode(self.model._strip_pads(analysis[i]),
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
        self.batches_run += 1
        self.requests_served += n_real


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


def _build_server(config_path, device="cuda") -> DesignServer:
    """Config YAML (or dict) -> started DesignServer on `device`.
    The YAML parser is config/ (needs PyYAML)."""
    device = resolve_device(device)
    from .config import get_infer_args

    from .models.loader import build_graph_lm

    model_args, data_args, _training_args, finetuning_args, ga = \
        get_infer_args(config_path)
    if getattr(ga, "continuous_batching", False):
        raise NotImplementedError("continuous batching is not ported to "
                                  "llamole_tpu_torch yet (ROADMAP.md)")
    model, tok = build_graph_lm(
        model_args, data_args, finetuning_args, device=device,
        generate_mode=True, load_adapter=bool(model_args.adapter_name_or_path))
    gen = GenerationSettings(
        max_new_tokens=ga.max_new_tokens, temperature=ga.temperature,
        top_p=ga.top_p, top_k=ga.top_k, do_sample=ga.do_sample,
        repetition_penalty=ga.repetition_penalty,
        speculative_tokens=ga.speculative_tokens,
        speculative_ngram=ga.speculative_ngram)
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m llamole_tpu_torch.serve",
        description="JSONL design / retrosynthesis serving on stdin/stdout")
    ap.add_argument("config", nargs="?", default=None,
                    help="inference YAML (config/args.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to serve "
                         "without a card)")
    args = ap.parse_args(argv)
    serve_jsonl(args.config, device=args.device)


if __name__ == "__main__":
    main()
