"""Step-timing callbacks for user training loops (`bench show` feed).

Usage::

    import skypilot_tpu_torch.callbacks as sky_callback
    sky_callback.init(total_steps=1000)
    for batch in data:
        with sky_callback.step():
            train_step(...)

Writes a rolling summary (steps done, avg step seconds, ETA) to
``$SKYPILOT_TPU_HOME/benchmark_summary.json`` (override with
``SKYTPU_CALLBACK_LOG_DIR``), which `bench show` and the jobs dashboard
read.

Copy of ``skypilot_tpu/callbacks/__init__.py``: the same summary file
and keys, so `bench show` reads a run of either package.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

_state: Optional[Dict[str, Any]] = None

SUMMARY_FILE = "benchmark_summary.json"
_WRITE_EVERY_S = 10.0


def _log_dir() -> str:
    d = os.environ.get("SKYTPU_CALLBACK_LOG_DIR")
    if d:
        os.makedirs(d, exist_ok=True)
        return d
    from skypilot_tpu_torch.utils import paths
    return paths.home()


def init(total_steps: Optional[int] = None,
         warmup_steps: int = 1) -> None:
    """Start timing. ``warmup_steps`` are excluded from the average
    (a first step's one-time costs would poison the step stats)."""
    global _state
    _state = {
        "total_steps": total_steps,
        "warmup_steps": warmup_steps,
        "steps": 0,
        "timed_steps": 0,
        "timed_seconds": 0.0,
        "started_s": time.time(),
        "last_write_s": 0.0,
    }


@contextlib.contextmanager
def step():
    if _state is None:
        yield
        return
    begin = time.time()
    yield
    dur = time.time() - begin
    _state["steps"] += 1
    if _state["steps"] > _state["warmup_steps"]:
        _state["timed_steps"] += 1
        _state["timed_seconds"] += dur
    now = time.time()
    if now - _state["last_write_s"] >= _WRITE_EVERY_S:
        _state["last_write_s"] = now
        write_summary()


def summary() -> Dict[str, Any]:
    if _state is None:
        return {}
    avg = (_state["timed_seconds"] / _state["timed_steps"]
           if _state["timed_steps"] else None)
    total = _state["total_steps"]
    eta = (avg * (total - _state["steps"])
           if avg and total and total > _state["steps"] else None)
    return {
        "steps": _state["steps"],
        "total_steps": total,
        "avg_step_s": round(avg, 6) if avg else None,
        "eta_s": round(eta, 1) if eta else None,
        "elapsed_s": round(time.time() - _state["started_s"], 1),
    }


def write_summary() -> None:
    if _state is None:
        return
    path = os.path.join(_log_dir(), SUMMARY_FILE)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(summary(), f)
