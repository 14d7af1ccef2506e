"""What every cell shares: finding a cell, its configuration, its traffic
and its limits by name; the run's environment; the device's description;
the guard against JAX in the process; span recording; metric readers;
the result line.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
FORBIDDEN = ("jax", "jaxlib", "flax", "llamole_tpu")
CACHE = os.path.join(ROOT, ".perfbench_cache")


def prepare_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; keep
    libraries from loading JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


class Cell:
    """One entry of BENCHMARK.json's workloads with its configuration,
    traffic and limits, each read from its own file."""

    def __init__(self, name: str, root: str = ROOT):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(has {sorted(cells)})")
        self.bench = bench
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        self.traffic = read_json(os.path.join(
            PB, "workloads", f"{self.entry['traffic']}.json"))
        self.limits = read_json(os.path.join(PB, "limits", f"{name}.json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def check_device(chips: int):
    """Refuse to run without the cards the cell asks for."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("perfbench: no CUDA device")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"perfbench: {torch.cuda.device_count()} CUDA "
                         f"devices, the cell needs {chips}")


def card_tag() -> str:
    """The card's name and power limit from nvidia-smi ('' when it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.splitlines()[0] if out else ""


def forbidden_loaded() -> List[str]:
    """Top-level names of sys.modules that are JAX or the JAX package,
    compared whole (llamole_tpu_torch is not llamole_tpu)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Spans:
    """Host-clock spans around calls into the program's layers, recorded
    from outside by wrapping methods: name -> [(start, end)]; each end is
    taken after a synchronisation of the card when `sync` is set."""

    def __init__(self, sync: bool):
        self.sync = sync
        self.log: Dict[str, list] = {}
        self._lock = threading.Lock()
        self.wrapped = []

    def _sync(self):
        if self.sync:
            import torch
            torch.cuda.synchronize()

    def wrap(self, obj, attr: str, name: str, before=None, after=None):
        """Time every call of obj.attr as span `name`; before(args,
        kwargs) and after(result, args, kwargs) run inside it."""
        fn = getattr(obj, attr)
        spans = self

        def wrapper(*args, **kwargs):
            from torch.profiler import record_function
            if before is not None:     # outside the span: a profiler start
                before(args, kwargs)
            with record_function(f"perfbench::{name}"):
                spans._sync()
                t0 = time.monotonic()
                out = fn(*args, **kwargs)
                spans._sync()
                t1 = time.monotonic()
            if after is not None:      # outside the span: a profiler stop
                after(out, args, kwargs)
            with spans._lock:
                spans.log.setdefault(name, []).append((t0, t1))
            return out

        setattr(obj, attr, wrapper)
        self.wrapped.append((obj, attr, fn))

    def record_all(self, name: str, pairs) -> None:
        with self._lock:
            self.log.setdefault(name, []).extend(pairs)

    def unwrap(self) -> None:
        for obj, attr, fn in reversed(self.wrapped):
            setattr(obj, attr, fn)
        self.wrapped.clear()


def load_reader(metric: str):
    """perfbench/metrics/<metric>.py's read(run) -> value or None."""
    path = os.path.join(PB, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a driver hands back: end-to-end values, what the per-layer
    readers read (spans, counters, the trace, shapes), the compared
    numbers with their limits, and the device's description."""

    def __init__(self):
        self.e2e: Dict[str, float] = {}
        self.spans: Optional[Spans] = None
        self.counters: Dict[str, Any] = {}
        self.trace: Optional[dict] = None
        self.shapes: Dict[str, Any] = {}
        self.checks: List[tuple] = []        # (name, value, limit)
        self.attempted = 0
        self.failed = 0
        self.device: Dict[str, Any] = {}
        self.notes: Dict[str, Any] = {}

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v == v and v <= lim for _, v, lim in self.checks)


def result_line(run: Run, cell: Cell, trace: bool) -> dict:
    metrics = {}
    entries = cell.per_layer if trace else cell.end_to_end
    for m in entries:
        if trace:
            value = load_reader(m["name"])(run)
        else:
            value = run.e2e.get(m["name"])
        if value is None:
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": run.correct, "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics,
            "device": run.device}
    if trace and run.trace is not None and run.trace.get("breakdown"):
        line["breakdown"] = run.trace["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in run.checks}
    return line


def print_checks(run: Run) -> None:
    """Each compared number beside its limit, the last lines of stderr."""
    for name, v, lim in run.checks:
        state = "ok" if v == v and v <= lim else "FAIL"
        print(f"check {name} {v!r} limit {lim!r} {state}", file=sys.stderr,
              flush=True)
