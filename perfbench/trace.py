"""The traced window: torch.profiler over a fixed number of the cell's
units (design batches, micro steps), started and stopped at unit
boundaries, reduced to what the per-layer metrics and the ledger read:

  busy_s      the union of the device's activity intervals (kernels,
              copies, sets) inside the window
  window_s    the window's length
  kernels     {kernel name: [count, device seconds]}
  breakdown   the device operations that took most time, and the idle
              gaps summed by the benchmark span the host was in when each
              began (the innermost; gaps under 20 us, the launch gaps
              between kernels, apart)

On the card the profiler records the device's activity alone: recording
every host operation as well slowed a traced micro step about twofold,
which would read as idle device time. The benchmark's spans (host clock)
say what the host was doing, placed on the trace's clock by the window's
start.
"""

import time
from typing import Dict, List, Optional


class UnitTracer:
    """Profiles units skip .. skip + units - 1 of a stream of units; call
    begin() and end() around each unit, on the thread that runs it."""

    def __init__(self, skip: int, units: int):
        self.skip, self.units = skip, units
        self.seen = 0
        self.prof = None
        self.t0 = self.t1 = None
        self.summary: Optional[dict] = None

    def begin(self) -> None:
        if self.seen == self.skip and self.prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                acts = [ProfilerActivity.CUDA]
            else:
                acts = [ProfilerActivity.CPU]
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.t0 = time.monotonic()

    def end(self) -> None:
        self.seen += 1
        if self.prof is not None and self.seen == self.skip + self.units:
            import torch
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.t1 = time.monotonic()
            self.prof.__exit__(None, None, None)

    @property
    def done(self) -> bool:
        return self.t1 is not None

    def reduce(self, spans: Dict[str, list]) -> Optional[dict]:
        """The summary; spans: {name: [(start, end)]} on the host clock."""
        if not self.done:
            return None
        if self.summary is None:
            host = [((a - self.t0) * 1e6, (b - self.t0) * 1e6, name)
                    for name, pairs in spans.items() for a, b in pairs
                    if b >= self.t0 and a <= self.t1]
            self.summary = summarize(self.prof, self.t1 - self.t0, host)
            self.prof = None
        return self.summary


def _union(intervals: List[tuple]) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def summarize(prof, window_s: float, host: List[tuple]) -> dict:
    """host: [(start us, end us, name)] on the trace's clock."""
    from torch.autograd import DeviceType
    device = []
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            tr = evt.time_range
            device.append((tr.start, tr.end, evt.name))
    kernels: Dict[str, list] = {}
    for a, b, name in device:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _ in device]) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    gaps: Dict[str, float] = {}
    ordered = sorted(device)
    end = ordered[0][1] if ordered else None
    for a, b, _ in ordered[1:]:
        if a > end:
            who = (_host_at(host, end) if a - end >= 20
                   else "gaps under 20 us")
            gaps[who] = gaps.get(who, 0.0) + (a - end) * 1e-6
        end = max(end, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s, "kernels": kernels,
            "device_events": len(device),
            "breakdown": {"device_ops": [[n[:160], v[1]] for n, v in top],
                          "idle_gaps": [[n, v] for n, v in idle]}}


def _host_at(host: List[tuple], t: float) -> str:
    """The innermost benchmark span open at time t ('outside spans')."""
    best = None
    for a, b, name in host:
        if a <= t <= b and (best is None or a >= best[0]):
            best = (a, b, name)
    return best[2] if best else "outside spans"


def kernel_time(summary: dict, needle: str) -> tuple:
    """(count, device seconds) of the kernels whose names hold needle."""
    n, s = 0, 0.0
    for name, (c, sec) in summary["kernels"].items():
        if needle in name:
            n += c
            s += sec
    return n, s
