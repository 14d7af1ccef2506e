"""The port's tracing: spans and counters at the design path's layer
boundaries, and torch.profiler traces (counterpart of
llamole_tpu/utils/profiling.py's trace()).

  span(name, device)   a with-block kept in memory while a torch profiler
                       is active in the process (trace() below, or any
                       other torch.profiler.profile); otherwise one flag
                       test and a shared no-op object: no allocation, no
                       CUDA event, no synchronisation
  batch(name, number)  the span of one served batch: spans opened inside
                       it on its thread carry `number`
  count(name, n)       always-on counters, bumped per request, call, step
  add(name, seconds)   or graph, never reading the device
  snapshot()           the spans, the counters and the kernels' launch
                       counters; reset() clears spans and counters

Spans are stamped with time.time_ns(), the Unix-epoch clock Kineto stamps
its events with, so `prof.profiler.kineto_results.trace_start_ns()`
places them on the timeline of `prof.events()`. A span's parent is the
innermost span open on its thread when it opened.
"""

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from .logging import get_logger

logger = get_logger(__name__)

_lock = threading.Lock()
_counters: Dict[str, float] = {}
# recorded spans in the order they opened: [id, name, parent id, batch,
# thread, start ns, end ns, device], device None (a host span), "wall"
# (device work on the CPU: its wall), a (start, end) CUDA event pair, or,
# once read, the device milliseconds
_spans: List[list] = []
_ids = itertools.count()
_local = threading.local()


def recording() -> bool:
    """Whether a torch profiler is active in the process: spans record
    only then."""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


# what span() returns while no profiler is active
_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "fn", "cuda")

    def __init__(self, name: str, device: Optional[torch.device]):
        stack = _stack()
        self.rec = [next(_ids), name, stack[-1] if stack else None,
                    getattr(_local, "batch", None), threading.get_ident(),
                    None, None, None]
        self.cuda = (device if device is not None and device.type == "cuda"
                     else None)
        if device is not None and self.cuda is None:
            self.rec[7] = "wall"
        self.fn = torch.profiler.record_function(name)

    def __enter__(self):
        rec = self.rec
        _stack().append(rec[0])
        rec[5] = time.time_ns()
        _spans.append(rec)
        self.fn.__enter__()
        if self.cuda is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.cuda))
            rec[7] = (start, None)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.cuda is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.cuda))
            rec[7] = (rec[7][0], end)
        self.fn.__exit__(*exc)
        rec[6] = time.time_ns()
        _stack().pop()
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A with-block recorded while a torch profiler is active: its name,
    start and end (time.time_ns()), its parent, its thread's batch
    number, and inside a torch.profiler.record_function(name), so that
    trace() shows it over the kernels it launched. device: where the
    block's work runs; on a CUDA device a timing event pair is recorded
    on the current stream at its start and end (never waited on; read by
    snapshot()): its device time is the stream's from the one to the
    other, the block's kernels and any wait of the stream for their
    launch. On the CPU its device time is its wall."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, device)


@contextlib.contextmanager
def batch(name: str, number: int) -> Iterator[None]:
    """The span `name` of served batch `number`: spans opened inside it
    on this thread carry the number."""
    prev = getattr(_local, "batch", None)
    _local.batch = number
    try:
        with span(name):
            yield
    finally:
        _local.batch = prev


def count(name: str, n: float = 1) -> None:
    """Add n to counter `name` (always on)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def add(name: str, seconds: float) -> None:
    """Add seconds to the sum `name` (always on)."""
    count(name, float(seconds))


def counters() -> Dict[str, float]:
    """A copy of the counters."""
    with _lock:
        return dict(_counters)


def _launch_counters() -> Dict[str, int]:
    """The kernels' launch counters and LLM.graph_replays, read from the
    functions and the class that keep them."""
    from ..models.gllm.model import LLM
    from ..ops import flash_attention, fused_attention, gin_aggregate, nn
    from ..ops import graph_attention
    out = {}
    for fn in (fused_attention.fused_block_attention,
               graph_attention.graph_attention,
               flash_attention.flash_attention, gin_aggregate.gin_aggregate,
               gin_aggregate.gin_aggregate_backward, nn.int8_matmul):
        for attr in sorted(vars(fn)):
            if attr.startswith("launches"):
                out[f"{fn.__name__}.{attr}"] = getattr(fn, attr)
    out["LLM.graph_replays"] = LLM.graph_replays
    return out


def _device_ms(rec: list) -> Optional[float]:
    dev = rec[7]
    if dev is None or isinstance(dev, float):
        return dev
    if dev == "wall":
        ms = (rec[6] - rec[5]) * 1e-6
    else:
        dev[1].synchronize()
        ms = float(dev[0].elapsed_time(dev[1]))
    rec[7] = ms           # the events are read once and let go
    return ms


def snapshot() -> Dict[str, Any]:
    """{"spans": [{id, name, parent (its id), batch, thread, start_ns,
    end_ns, wall_ms, device_ms}] of the spans that closed, in the order
    they opened (device_ms None for a host span; reading a CUDA span's
    events waits for them), "counters": counters(), "launches": the
    kernels' launch counters and LLM.graph_replays}."""
    spans = []
    for rec in sorted(_spans, key=lambda r: r[5]):
        if rec[6] is None:
            continue
        spans.append({"id": rec[0], "name": rec[1], "parent": rec[2],
                      "batch": rec[3], "thread": rec[4],
                      "start_ns": rec[5], "end_ns": rec[6],
                      "wall_ms": (rec[6] - rec[5]) * 1e-6,
                      "device_ms": _device_ms(rec)})
    return {"spans": spans, "counters": counters(),
            "launches": _launch_counters()}


def reset(counters: bool = True) -> None:
    """Forget every span, and with `counters` every counter."""
    with _lock:
        if counters:
            _counters.clear()
        _spans.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace into log_dir (or LLAMOLE_TRACE_DIR)
    when one is set; no-op otherwise. CPU activities always, CUDA
    activities when a card is present. The program's spans (span() above)
    record inside it and appear in the trace as record_function events
    over the kernels they launched; their records (and CUDA events) are
    dropped when it ends, the counters kept. A profiler that fails to start or to
    write raises: the block never runs untraced under a traced name."""
    log_dir = log_dir or os.environ.get("LLAMOLE_TRACE_DIR")
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(path)
    finally:
        reset(counters=False)     # the trace holds the spans; drop records
    logger.info("profiler trace written to %s", path)
