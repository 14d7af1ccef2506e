"""Stdout logging with an optional jsonl sink.

Behavioral counterpart of the reference's src/extras/logging.py:59
(per-module stdout logger) plus the async trainer_log.jsonl appender
(src/train/callbacks.py:214-216). Kept synchronous here — log volume is
low and a single-writer append is cheap on the host.
"""

import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

_FORMAT = "%(asctime)s [%(levelname)s|%(name)s] %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"
_configured = False
_lock = threading.Lock()


def get_logger(name: str) -> logging.Logger:
    global _configured
    with _lock:
        if not _configured:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
            root = logging.getLogger("llamole_tpu_torch")
            root.setLevel(logging.INFO)
            root.addHandler(handler)
            root.propagate = False
            _configured = True
    if not name.startswith("llamole_tpu_torch"):
        name = f"llamole_tpu_torch.{name}"
    return logging.getLogger(name)


class JsonlLogger:
    """Append-only jsonl metric log (trainer_log.jsonl parity)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("time", time.time())
        line = json.dumps(record, default=float)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


class Timer:
    """Context-manager wall-clock timer for phase accounting."""

    def __init__(self, name: str = "", logger: Optional[logging.Logger] = None):
        self.name = name
        self.logger = logger
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.logger is not None:
            self.logger.info("%s took %.3fs", self.name, self.elapsed)
        return False
