"""Checkpoint/resume of the train state in torch's own format.

Counterpart of ``skypilot_tpu/train/checkpoints.py`` (Orbax there), with
its semantics:

- ``save`` is asynchronous. It takes a host copy of the state before it
  returns, and only the write runs in a background thread. The copy is
  needed because the port's train step updates the state in place (JAX
  arrays are immutable, so Orbax could read them later).
- ``wait`` blocks until queued saves are durable (written, flushed,
  renamed into place); ``close`` waits and leaves no thread behind.
- A step is saved when it is a multiple of ``save_interval_steps`` and
  later than the latest saved step, or when ``force`` is set; a step
  already saved is never written again. Only the newest
  ``max_to_keep`` steps are kept.

Layout: ``<directory>/<step>/state.pt``, a ``torch.save`` of the state
with every tensor on the CPU. A step directory appears only once its
file is complete, so a crash mid-write leaves no partial step behind.

Observability is the reference's: the ``skytpu_checkpoint_*`` and
``skytpu_ckpt_*`` families, the ``train.checkpoint_{save,wait,restore}``
tracing spans, the timeline spans that record into the save and wait
histograms, and the ``train.checkpoint_save``/``train.checkpoint_restore``
chaos points. ``save``'s inline cost here includes the host copy of the
state (a device-to-host read of every tensor); ``wait`` is the write's
durability tail.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, List, Optional

import torch

from skypilot_tpu_torch import DeviceLike, chaos
from skypilot_tpu_torch.observability import attribution
from skypilot_tpu_torch.observability import metrics as obs_metrics
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.utils import timeline

_FILE = "state.pt"

# Saves are async: ``_save_seconds`` is the dispatch cost the train
# loop pays inline; ``_wait_seconds`` is the durability tail paid at
# wait(). Their sum bounds the true checkpoint wall time.
CKPT_SAVE_SECONDS = obs_metrics.histogram(
    "skytpu_checkpoint_save_seconds",
    "CheckpointManager.save dispatch latency (async saves: the inline "
    "cost only)")
CKPT_WAIT_SECONDS = obs_metrics.histogram(
    "skytpu_checkpoint_wait_seconds",
    "CheckpointManager.wait latency (async save durability tail)")
CKPT_SAVES = obs_metrics.counter(
    "skytpu_checkpoint_saves_total", "Checkpoint saves accepted")
CKPT_BYTES = obs_metrics.gauge(
    "skytpu_ckpt_bytes",
    "Analytical bytes of the last saved checkpoint state by tensor "
    "family (params, opt_state, total) — nbytes metadata only, never "
    "a device fetch",
    labelnames=("kind",))
CKPT_LAST_DURATION = obs_metrics.gauge(
    "skytpu_ckpt_last_duration_seconds",
    "Most recent checkpoint operation wall seconds by op (save = "
    "async dispatch, wait = durability tail, restore = full restore "
    "wall) — restore feeds the goodput restart_replay bucket",
    labelnames=("op",))


def _publish_state_bytes(state: Any) -> None:
    total = attribution.tensor_bytes(state)
    CKPT_BYTES.labels(kind="total").set(total)
    if hasattr(state, "get"):
        for kind in ("params", "opt_state"):
            part = state.get(kind)
            if part is not None:
                CKPT_BYTES.labels(kind=kind).set(
                    attribution.tensor_bytes(part))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _host_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


class CheckpointManager:
    """Async snapshots of a train state (nested dicts of tensors and
    Python scalars).

    Usage::

        with CheckpointManager(path, max_to_keep=3) as mgr:
            for step in range(...):
                state, metrics = train_step(state, batch)
                mgr.save(step, state)      # returns once the copy is taken
            mgr.wait()
        state = CheckpointManager(path).restore(device="cuda")
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._pending: Optional[int] = None

    def all_steps(self) -> List[int]:
        """Saved steps, ascending (a save still being written counts)."""
        steps = {int(n) for n in os.listdir(self.directory)
                 if n.isdigit()
                 and os.path.exists(os.path.join(self.directory, n, _FILE))}
        if self._pending is not None:
            steps.add(self._pending)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Queue an async save of ``state`` at ``step``. Returns False
        when skipped (interval, or not later than the latest step)."""
        step = int(step)
        chaos.point("train.checkpoint_save", step=step)
        t0 = time.monotonic()
        with tracing.start_span("train.checkpoint_save",
                                attrs={"step": step}), \
                timeline.Event("skytpu_checkpoint_save_seconds",
                               histogram=CKPT_SAVE_SECONDS):
            saved = self._save(step, state, force)
        CKPT_LAST_DURATION.labels(op="save").set(time.monotonic() - t0)
        if saved:
            CKPT_SAVES.inc()
            _publish_state_bytes(state)
        return saved

    def _save(self, step: int, state: Any, force: bool) -> bool:
        steps = self.all_steps()
        if step in steps:
            return False
        if not force and ((steps and step <= steps[-1])
                          or step % self.save_interval_steps):
            return False
        self._join()
        snapshot = _map(_host_copy, state)
        self._pending = step
        self._writer = threading.Thread(
            target=self._write, args=(step, snapshot),
            name=f"ckpt-save-{step}")
        self._writer.start()
        return True

    def _write(self, step: int, snapshot: Any) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        try:
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, _FILE), "wb") as f:
                torch.save(snapshot, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.directory, str(step)))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        except Exception as e:  # noqa: BLE001 — re-raised by wait()
            self._error = e
            shutil.rmtree(tmp, ignore_errors=True)

    def wait(self) -> None:
        """Block until queued saves are durable; re-raise a failed write."""
        t0 = time.monotonic()
        with tracing.start_span("train.checkpoint_wait"), \
                timeline.Event("skytpu_checkpoint_wait_seconds",
                               histogram=CKPT_WAIT_SECONDS):
            self._join()
        CKPT_LAST_DURATION.labels(op="wait").set(time.monotonic() - t0)

    def _join(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, target: Optional[Any] = None,
                step: Optional[int] = None,
                device: DeviceLike = None) -> Any:
        """The state saved at ``step`` (default: the latest). With
        ``target`` (a state of the same structure) the saved tensors
        are copied into the target's tensors in place, which must match
        in shape and dtype, and the target is returned with its scalars
        replaced; without one, tensors land on ``device`` (default: the
        CPU)."""
        self._join()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        chaos.point("train.checkpoint_restore", step=int(step))
        t0 = time.monotonic()
        with tracing.start_span("train.checkpoint_restore",
                                attrs={"step": int(step)}):
            out = self._restore(int(step), target, device)
        CKPT_LAST_DURATION.labels(op="restore").set(
            time.monotonic() - t0)
        return out

    def _restore(self, step: int, target: Optional[Any],
                 device: DeviceLike) -> Any:
        path = os.path.join(self.directory, str(step), _FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint for step {step} under "
                                    f"{self.directory}")
        saved = torch.load(path, map_location="cpu", weights_only=True)
        if target is None:
            dev = torch.device(device) if device is not None else None
            return _map(lambda x: x.to(dev) if dev is not None
                        and isinstance(x, torch.Tensor) else x, saved)
        return _copy_into(target, saved)

    def close(self) -> None:
        self._join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _copy_into(target: Any, saved: Any) -> Any:
    if isinstance(target, dict):
        if set(target) != set(saved):
            raise ValueError(f"checkpoint keys {sorted(saved)} do not match "
                             f"the target's {sorted(target)}")
        for k in target:
            target[k] = _copy_into(target[k], saved[k])
        return target
    if isinstance(target, torch.Tensor):
        if target.shape != saved.shape or target.dtype != saved.dtype:
            raise ValueError(f"checkpoint tensor {tuple(saved.shape)} "
                             f"{saved.dtype} does not match the target's "
                             f"{tuple(target.shape)} {target.dtype}")
        with torch.no_grad():
            target.copy_(saved)
        return target
    return saved
