"""Profiling hooks: torch.profiler traces + phase timers (counterpart of
llamole_tpu/utils/profiling.py).

Wrap any phase in ``trace(...)`` to write a Chrome trace (chrome://tracing,
Perfetto) of its host ops and, on the card, its CUDA kernels; or use
PhaseTimer for wall-clock accounting of phases. `python -m
llamole_tpu_torch <command>` runs the command inside trace(), so
LLAMOLE_TRACE_DIR=<dir> traces any entry point.
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

from .logging import get_logger

logger = get_logger(__name__)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace into log_dir (or LLAMOLE_TRACE_DIR)
    when one is set; no-op otherwise. CPU activities always, CUDA
    activities when a card is present. A profiler that fails to start or
    to write raises: the block never runs untraced under a traced name."""
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
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


class PhaseTimer:
    """Accumulating per-phase wall-clock timer."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"total_s": self.totals[name], "count": self.counts[name],
                   "mean_s": self.totals[name] / max(self.counts[name], 1)}
            for name in self.totals
        }
