"""Multi-LoRA adapter catalog: one base model, a fleet of fine-tunes.

Counterpart of ``skypilot_tpu/infer/adapters.py``. Rank-R adapters live
in a device-resident STACKED pool (``[L, n_adapters, d_in..., r]`` /
``[L, n_adapters, r, d_out...]`` per target projection) and every
decode, verify, chunk and wave program gathers each slot's (A, B) pair
into the batched products (``infer/kvcache.py``, ``_lora_in_delta`` /
``_lora_out_delta``), so requests for different fine-tunes batch into
one call. Pool slot 0 is the all-zeros BASE adapter: ``x @ A`` with
``A == 0`` adds an exact-zero delta, so "no adapter" runs the same code
and its greedy output is bit-identical to an adapterless engine's.

Adapter identity is DATA, never program identity: the pool's capacity
is an engine constant, the per-slot adapter id rides as a device tensor
beside the block table, and :func:`pool_install` writes one pool slot
IN PLACE (``copy_`` into a view). The pool's tensors therefore never
move across hot loads and evictions (their ``data_ptr()`` is constant),
which is what a captured CUDA graph of the decode step will need.

Host-side bookkeeping, copied from the reference unchanged:

* checkpoints are CONTENT-ADDRESSED (blake2b-128 over alpha and the
  stacked weight bytes, :func:`_content_digest`, byte-equal to the
  reference's) -- two names registering identical bytes share one pool
  slot;
* hot-load/evict is LRU over resident, UNPINNED slots; a slot is pinned
  while any decode slot references it (refcounts bumped at claim,
  dropped at retirement or preemption);
* a load failure (after one retry) fails the REQUEST typed
  (:class:`AdapterLoadError`, HTTP 503) -- never a silent fall-through
  to the base model's weights.

The ``alpha / rank`` LoRA scale folds into B at load time, and an
adapter whose rank is below the pool's zero-pads.

Weights reach the port as numpy, exactly as base weights do: an
in-memory tree (``register(name, params=...)``, per target
``{"a": [L, ..., r], "b": [L, r, ...]}`` numpy arrays) or a ``.npz``
file written by either package's :func:`save_adapter`, whose format is
the reference's, so files cross between the packages both ways. No
other conversion function is needed.

Each load attempt rides the ``adapter.load`` chaos point. Deliberate
differences from the reference: the port has no tracing layer, so the
``adapter.load_failed`` and ``adapter.env_invalid`` events print one
JSON line on stderr. The retry is a local copy of the reference's
policy (2 attempts, backoff 0.05-0.25 s, retry on OSError,
ConnectionError and RuntimeError), not its ``utils/retry`` module.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, chaos, resolve_device
from skypilot_tpu_torch.observability import metrics, tracing

# The request header naming a fine-tune (the body's ``model`` field is
# the SDK path) -- shared by the model server and the LB so the two
# tiers can never disagree on where the name rides.
MODEL_HEADER = "x-skytpu-model"

# The reference's LoRA targets: per target, the base weight's (input
# dims, output dims) after the layer axis (:func:`target_shapes`).
TARGETS = ("wq", "wk", "wv", "wo")

ADAPTER_LOADS = metrics.counter(
    "skytpu_adapter_loads_total",
    "Adapter checkpoints hot-loaded into the device-resident pool "
    "(a prefix-cache-style demand load: the first request naming a "
    "non-resident adapter pays it, later ones gather warm)")
ADAPTER_EVICTIONS = metrics.counter(
    "skytpu_adapter_evictions_total",
    "Resident adapters evicted (LRU over unpinned pool slots) to "
    "hot-load another — an adapter pinned by an in-flight request "
    "is never evicted")
ADAPTER_ACTIVE = metrics.gauge(
    "skytpu_adapter_active",
    "Adapters currently resident in the device pool (the base "
    "all-zeros slot 0 is not counted)")
ADAPTER_SLOTS = metrics.gauge(
    "skytpu_adapter_slots",
    "Adapter-pool capacity: fine-tune slots available per engine "
    "(pool slot 0 is reserved for the all-zeros base adapter)")


class UnknownAdapterError(ValueError):
    """Request names a fine-tune the catalog has never heard of. A
    CLIENT error — HTTP 404 with a typed body at both the LB and the
    model server (``{"type": "unknown_adapter"}``) — never a 500."""

    http_status = 404

    def __init__(self, name: str, known: Optional[List[str]] = None):
        super().__init__(f"unknown adapter {name!r}")
        self.adapter = name
        self.typed_error = {
            "type": "unknown_adapter",
            "adapter": name,
            "message": str(self),
        }
        if known is not None:
            self.typed_error["known"] = sorted(known)[:32]


class AdapterLoadError(RuntimeError):
    """Hot-loading a registered adapter's checkpoint failed (after
    retries). The REQUEST fails typed with this body — falling through
    to the base model's weights would silently serve the wrong
    model."""

    http_status = 503

    def __init__(self, name: str, reason: str):
        super().__init__(f"adapter {name!r} failed to load: {reason}")
        self.adapter = name
        self.typed_error = {
            "type": "adapter_load_failed",
            "adapter": name,
            "message": str(self),
        }


@dataclasses.dataclass
class _Entry:
    """One registered adapter. ``params``/``path`` is the checkpoint
    (host arrays, or an .npz on disk loaded on first demand);
    ``digest`` is the content address, computed at registration for
    in-memory params and at first load for paths."""

    name: str
    params: Optional[Dict[str, Any]] = None
    path: Optional[str] = None
    alpha: float = 32.0
    rank: Optional[int] = None
    digest: Optional[bytes] = None


def _dims(cfg, axes: Tuple[str, ...]) -> Tuple[int, ...]:
    m = {"embed": cfg.d_model, "heads": cfg.n_heads,
         "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim}
    return tuple(m[a] for a in axes)


def target_shapes(cfg, rank: int) -> Dict[str, Tuple[Tuple[int, ...],
                                                     Tuple[int, ...]]]:
    """Per target, the (a, b) shapes AFTER the leading [L, N] pool
    dims — the single geometry definition (the reference's
    ``train/lora.py`` ``_TARGETS``)."""
    geo = {
        "wq": (("embed",), ("heads", "head_dim")),
        "wk": (("embed",), ("kv_heads", "head_dim")),
        "wv": (("embed",), ("kv_heads", "head_dim")),
        "wo": (("heads", "head_dim"), ("embed",)),
    }
    out = {}
    for t, (in_axes, out_axes) in geo.items():
        out[t] = (_dims(cfg, in_axes) + (rank,),
                  (rank,) + _dims(cfg, out_axes))
    return out


def init_adapter_pool(cfg, n_adapters: int, rank: int, dtype=None,
                      device: DeviceLike = None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The device-resident stacked pool: per target
    ``{"a": [L, N, d_in..., r], "b": [L, N, r, d_out...]}`` zeros on
    ``device``. The layer axis LEADS, so a program's layer ``i`` reads
    ``pool[t]["a"][i]``; slot 0 stays all-zeros forever (the base
    adapter — an exact-zero delta)."""
    dtype = dtype if dtype is not None else cfg.dtype
    device = resolve_device(device)
    L = cfg.n_layers
    pool: Dict[str, Dict[str, torch.Tensor]] = {}
    for t, (sa, sb) in target_shapes(cfg, rank).items():
        pool[t] = {
            "a": torch.zeros((L, n_adapters) + sa, dtype=dtype,
                             device=device),
            "b": torch.zeros((L, n_adapters) + sb, dtype=dtype,
                             device=device),
        }
    return pool


@torch.no_grad()
def pool_install(pool: Dict[str, Dict[str, torch.Tensor]], slot: int,
                 weights: Dict[str, Dict[str, torch.Tensor]]
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Write one adapter's stacked weights into pool slot ``slot`` IN
    PLACE (``copy_`` casts to the pool's dtype and device), and return
    the same pool: its tensors never move. ``weights``: per target
    ``{"a": [L, d_in..., r], "b": [L, r, d_out...]}`` with the
    alpha/rank scale already folded into ``b``."""
    for t, ab in pool.items():
        ab["a"][:, slot].copy_(weights[t]["a"])
        ab["b"][:, slot].copy_(weights[t]["b"])
    return pool


def lora_layer(pool: Optional[Dict[str, Dict[str, torch.Tensor]]],
               i: int) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
    """Layer ``i`` of the pool (views): per target ``{"a": [N, ...],
    "b": [N, ...]}``, or None without a pool."""
    if pool is None:
        return None
    return {t: {"a": ab["a"][i], "b": ab["b"][i]} for t, ab in pool.items()}


def save_adapter(path: str, params: Dict[str, Any],
                 alpha: float = 32.0) -> None:
    """Write a trained adapter tree (``train/lora.py`` layout: per
    target ``{"a": [L, ..., r], "b": [L, r, ...]}``, numpy arrays or
    tensors on any device) as the small .npz checkpoint the serve
    controller distributes to replicas."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    flat = {"__alpha__": np.asarray(alpha, np.float64)}
    for t, ab in params.items():
        flat[f"{t}.a"] = host(ab["a"])
        flat[f"{t}.b"] = host(ab["b"])
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_adapter_file(path: str) -> Tuple[Dict[str, Any], float]:
    """Read a ``save_adapter`` checkpoint -> (params tree, alpha)."""
    with np.load(os.path.expanduser(path)) as z:
        alpha = float(z["__alpha__"]) if "__alpha__" in z else 32.0
        params: Dict[str, Any] = {}
        for key in z.files:
            if key == "__alpha__":
                continue
            t, leaf = key.rsplit(".", 1)
            params.setdefault(t, {})[leaf] = z[key]
    return params, alpha


def _content_digest(params: Dict[str, Any], alpha: float) -> bytes:
    """blake2b-128 over alpha + the stacked weight bytes,
    target-ordered — the content address (a Python ``hash`` could
    collide and silently serve the wrong fine-tune). ``alpha`` is part
    of the identity: it folds into B at install time, so identical raw
    weights under different alphas are DIFFERENT effective models and
    must never share a pool slot."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.float64(alpha).tobytes())
    for t in sorted(params):
        for leaf in ("a", "b"):
            arr = np.ascontiguousarray(
                np.asarray(params[t][leaf], np.float32))
            h.update(t.encode())
            h.update(leaf.encode())
            h.update(arr.tobytes())
    return h.digest()


# The reference's load retry policy (``adapters.py`` ``_hot_load``).
_LOAD_ATTEMPTS = 2
_LOAD_BACKOFF_S = (0.05, 0.25)          # base, cap
_LOAD_RETRY_ON = (OSError, ConnectionError, RuntimeError)


def _load_with_retry(attempt: Callable[[], None]) -> None:
    """Run ``attempt`` up to :data:`_LOAD_ATTEMPTS` times: a transient
    failure (``_LOAD_RETRY_ON``, never a ValueError such as a rank the
    pool cannot hold) sleeps a capped, jittered exponential backoff
    and retries; anything else, or the last failure, re-raises."""
    for i in range(_LOAD_ATTEMPTS):
        try:
            return attempt()
        except Exception as e:  # noqa: BLE001 — classified below
            if (isinstance(e, ValueError)
                    or not isinstance(e, _LOAD_RETRY_ON)
                    or i + 1 >= _LOAD_ATTEMPTS):
                raise
            base, cap = _LOAD_BACKOFF_S
            time.sleep(min(base * 2 ** i, cap)
                       * (1.0 - 0.25 * random.random()))


class AdapterCatalog:
    """Host-side catalog over the device-resident adapter pool.

    Registration (``register``) may run from any thread — the registry
    dict rides ``_lock``. Residency/pin/pool state is LOOP-THREAD ONLY
    (the engine claims and retires there), mirroring the engine's
    block-table ownership model; the engine binds the install function
    via :meth:`bind_loader` before first use. ``device``: where the
    pool lives (the engine's device; None is the card).
    """

    def __init__(self, cfg, n_adapters: int = 8, rank: int = 16,
                 dtype=None, device: DeviceLike = None):
        if n_adapters < 2:
            raise ValueError(
                f"adapter pool needs >= 2 slots (slot 0 is the base "
                f"adapter), got {n_adapters}")
        if rank <= 0:
            raise ValueError(f"adapter rank must be positive, got {rank}")
        self.cfg = cfg
        self.rank = rank
        self.n_adapters = n_adapters
        self.pool = init_adapter_pool(cfg, n_adapters, rank, dtype, device)
        self._lock = threading.Lock()
        # name -> registered entry. guarded-by: _lock
        self._registry: Dict[str, _Entry] = {}
        # Loop-thread-only residency state (the engine's claim/retire
        # path is the sole mutator, exactly like the block table):
        self._resident: Dict[bytes, int] = {}      # digest -> pool slot
        self._slot_digest: Dict[int, bytes] = {}
        self._slot_name: Dict[int, str] = {}       # display only
        self._pins: Dict[int, int] = {}            # slot -> refcount
        self._used: Dict[int, int] = {}            # slot -> LRU tick
        self._tick = 0
        self._free: List[int] = list(range(n_adapters - 1, 0, -1))
        self._loader: Optional[Callable] = None
        self.loads = 0
        self.evictions = 0
        ADAPTER_SLOTS.set(n_adapters - 1)
        ADAPTER_ACTIVE.set(0)

    @property
    def device(self) -> torch.device:
        return self.pool["wq"]["a"].device

    # -- registration (any thread) -----------------------------------------

    def register(self, name: str, params: Optional[Dict] = None,
                 path: Optional[str] = None,
                 alpha: float = 32.0) -> None:
        """Make a fine-tune KNOWN (routable). Loading to device stays
        lazy — the first request naming it pays the hot-load. In-memory
        ``params`` are content-addressed immediately; a ``path``
        checkpoint hashes at first load."""
        if not name or not isinstance(name, str):
            raise ValueError(f"adapter name must be a non-empty string, "
                             f"got {name!r}")
        if (params is None) == (path is None):
            raise ValueError("register() needs exactly one of "
                             "params= or path=")
        ent = _Entry(name=name, params=params, path=path, alpha=alpha)
        if params is not None:
            self._validate(name, params)
            ent.rank = next(iter(params.values()))["a"].shape[-1]
            ent.digest = _content_digest(params, alpha)
        with self._lock:
            self._registry[name] = ent

    def register_entries(self, raw: str) -> int:
        """Register every adapter in a JSON ``{name: checkpoint
        path}`` catalog (how the serve controller hands a replica its
        catalog — ``SKYTPU_ADAPTERS`` / ``--adapters``). Returns how
        many registered; a malformed value registers nothing and a bad
        ENTRY skips that entry, loudly, so one typo cannot take the
        rest of the catalog down with it."""
        try:
            entries = json.loads(raw)
            if not isinstance(entries, dict):
                raise ValueError("expected a JSON object")
        except (ValueError, TypeError):
            tracing.add_event("adapter.env_invalid",
                              {"raw": raw[:200]}, echo=True)
            return 0
        n = 0
        for name, path in entries.items():
            try:
                self.register(str(name), path=str(path))
                n += 1
            except ValueError:
                tracing.add_event("adapter.env_invalid",
                                  {"adapter": str(name)[:64]}, echo=True)
        return n

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._registry)

    def check(self, name: Optional[str]) -> None:
        """Submit-time guard (handler threads): an unregistered name is
        a clean typed 404 BEFORE the request rides the inbox."""
        if name is None:
            return
        with self._lock:
            if name not in self._registry:
                raise UnknownAdapterError(name, list(self._registry))

    def _validate(self, name: str, params: Dict) -> None:
        shapes = target_shapes(self.cfg, self.rank)
        for t, ab in params.items():
            if t not in shapes:
                raise ValueError(f"adapter {name!r}: unknown target "
                                 f"{t!r}; supported: {sorted(shapes)}")
            r = ab["a"].shape[-1]
            if r > self.rank:
                raise ValueError(
                    f"adapter {name!r}: rank {r} exceeds the pool's "
                    f"rank {self.rank} (lower ranks zero-pad)")
            if ab["b"].shape[1] != r:
                raise ValueError(
                    f"adapter {name!r}: A rank {r} != B rank "
                    f"{ab['b'].shape[1]} on target {t!r}")

    # -- residency (engine loop thread only) -------------------------------

    def bind_loader(self, loader: Callable) -> None:
        """The engine's install function: ``loader(pool, slot, weights)
        -> pool`` (:func:`pool_install`, in place)."""
        self._loader = loader

    def resident_count(self) -> int:
        return len(self._resident)

    def slot_names(self) -> Dict[int, str]:
        """pool slot -> adapter name for resident slots (debug
        surfaces)."""
        return dict(self._slot_name)

    def pins(self, slot: int) -> int:
        return self._pins.get(slot, 0)

    def slot_content(self, slot: int) -> bytes:
        """The resident adapter's content digest (b"" for the base
        slot) — the engine's prefix-cache key salt, so warm prefixes
        follow the adapter's CONTENT across evict/reload cycles and
        across aliases."""
        return self._slot_digest.get(slot, b"")

    def acquire(self, name: Optional[str]) -> Optional[int]:
        """The pool slot serving ``name``, hot-loading (and evicting an
        LRU unpinned resident) when non-resident; the slot's in-flight
        refcount is bumped — :meth:`release` drops it at retirement or
        preemption. ``None`` (base model) is slot 0, never refcounted.

        Returns None — the STALL signal, mirroring the dry block
        pool — when every pool slot is pinned by an in-flight request:
        the engine re-queues the request and retries once a
        retirement unpins a slot. Raises :class:`UnknownAdapterError`
        for unregistered names and :class:`AdapterLoadError` when the
        checkpoint cannot load (after retries) — the caller fails the
        request typed, never falls through to the base weights."""
        if name is None:
            return 0
        with self._lock:
            ent = self._registry.get(name)
        if ent is None:
            raise UnknownAdapterError(name, self.names())
        if ent.digest is not None:
            slot = self._resident.get(ent.digest)
            if slot is not None:
                self._tick += 1
                self._used[slot] = self._tick
                self._pins[slot] = self._pins.get(slot, 0) + 1
                return slot
        slot = self._grab_slot()
        if slot is None:
            return None                     # all pinned: stall
        self._hot_load(ent, slot)
        self.loads += 1
        ADAPTER_LOADS.inc()
        # A path checkpoint's digest is only known AFTER the first
        # load: if it resolved to content that is ALREADY resident (a
        # path alias), keep the original slot — one digest must never
        # map two slots, or evicting either would pop the mapping out
        # from under the survivor. The freshly installed copy goes
        # back to the free list (its bytes are unreachable garbage
        # until the next install overwrites them).
        dup = self._resident.get(ent.digest)
        if dup is not None and dup != slot:
            self._free.append(slot)
            slot = dup
        else:
            self._resident[ent.digest] = slot
            self._slot_digest[slot] = ent.digest
            self._slot_name[slot] = ent.name
        self._tick += 1
        self._used[slot] = self._tick
        self._pins[slot] = self._pins.get(slot, 0) + 1
        ADAPTER_ACTIVE.set(len(self._resident))
        return slot

    def release(self, slot: Optional[int]) -> None:
        """Drop one in-flight reference (retirement / preemption).
        Slot 0 (base) carries no refcount; a slot at zero pins stays
        RESIDENT (warm for the next request) but becomes evictable."""
        if not slot:
            return
        n = self._pins.get(slot, 0) - 1
        if n > 0:
            self._pins[slot] = n
        else:
            self._pins.pop(slot, None)

    def _grab_slot(self) -> Optional[int]:
        """A free pool slot, else the LRU resident UNPINNED slot
        evicted; None when everything is pinned by in-flight
        requests (slot 0 never participates — the base adapter is
        pinned by construction)."""
        if self._free:
            return self._free.pop()
        victims = [s for s in self._used if not self._pins.get(s, 0)]
        if not victims:
            return None
        victim = min(victims, key=self._used.get)
        digest = self._slot_digest.pop(victim, None)
        if digest is not None:
            self._resident.pop(digest, None)
        self._slot_name.pop(victim, None)
        self._used.pop(victim, None)
        self.evictions += 1
        ADAPTER_EVICTIONS.inc()
        ADAPTER_ACTIVE.set(len(self._resident))
        # The evicted slot's pool weights stay as garbage until the
        # install below overwrites them; nothing maps an adapter id to
        # this slot until residency is re-recorded.
        return victim

    def _hot_load(self, ent: _Entry, slot: int) -> None:
        """Fetch + install one checkpoint into ``slot``. Each attempt
        rides the ``adapter.load`` chaos point; transient faults retry
        once (:func:`_load_with_retry`); exhaustion prints
        the typed ``adapter.load_failed`` event and raises — the caller
        fails the request typed instead of serving base weights."""
        if self._loader is None:
            raise AdapterLoadError(ent.name, "no loader bound")

        def attempt():
            chaos.point("adapter.load", adapter=ent.name)
            params = ent.params
            alpha = ent.alpha
            if params is None:
                params, alpha = load_adapter_file(ent.path)
                self._validate(ent.name, params)
            if ent.digest is None:
                ent.digest = _content_digest(params, alpha)
                ent.rank = next(iter(params.values()))["a"].shape[-1]
            weights = self._stack(params, alpha,
                                  next(iter(params.values()))
                                  ["a"].shape[-1])
            self.pool = self._loader(self.pool, slot, weights)

        try:
            _load_with_retry(attempt)
        except Exception as e:  # noqa: BLE001 — typed terminal failure
            self._free.append(slot)     # slot never became resident
            tracing.add_event(
                "adapter.load_failed",
                {"adapter": ent.name, "error": str(e)[:200]}, echo=True)
            raise AdapterLoadError(ent.name, str(e)) from e

    def _stack(self, params: Dict, alpha: float,
               rank: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Checkpoint tree -> install-shaped float32 host tensors: the
        alpha/rank scale folds into B (the device path stays a pure
        product pair), missing targets and rank columns zero-pad
        (exact-zero deltas)."""
        scale = alpha / rank
        shapes = target_shapes(self.cfg, self.rank)
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        L = self.cfg.n_layers
        for t, (sa, sb) in shapes.items():
            if t in params:
                a = np.asarray(params[t]["a"], np.float32)
                b = np.asarray(params[t]["b"], np.float32) * scale
                if rank < self.rank:
                    pad_a = np.zeros((L,) + sa, np.float32)
                    pad_a[..., :rank] = a
                    pad_b = np.zeros((L,) + sb, np.float32)
                    pad_b[:, :rank] = b
                    a, b = pad_a, pad_b
            else:
                a = np.zeros((L,) + sa, np.float32)
                b = np.zeros((L,) + sb, np.float32)
            out[t] = {"a": torch.from_numpy(np.ascontiguousarray(a)),
                      "b": torch.from_numpy(np.ascontiguousarray(b))}
        return out

    def zero_weights(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """An all-zero install-shaped weight tree."""
        return self._stack({}, 1.0, self.rank)

    def reset(self) -> None:
        """Drop all residency/pin state (the engine's reset path —
        a mid-load failure may have left pins inconsistent). The pool
        tensors stay; nothing maps to them until re-acquired."""
        self._resident.clear()
        self._slot_digest.clear()
        self._slot_name.clear()
        self._pins.clear()
        self._used.clear()
        self._free = list(range(self.n_adapters - 1, 0, -1))
        ADAPTER_ACTIVE.set(0)


def catalog_from_env(cfg, adapters_json: Optional[str] = None,
                     slots: Optional[int] = None,
                     rank: Optional[int] = None,
                     device: DeviceLike = None
                     ) -> Optional[AdapterCatalog]:
    """The engine's adapter catalog, or None when no catalog is
    configured (the adapterless path). THE bootstrap — the server's CLI
    flags pass through the explicit arguments and the serve
    controller's env distribution rides the defaults, so the two paths
    cannot drift: ``SKYTPU_ADAPTERS`` (JSON name->path) names the
    fine-tunes, ``SKYTPU_ADAPTER_SLOTS`` (default 8) the pool capacity
    and ``SKYTPU_ADAPTER_RANK`` (default 16) the pool rank. ``device``:
    where the pool lives (the engine's)."""
    raw = (adapters_json if adapters_json is not None
           else os.environ.get("SKYTPU_ADAPTERS", "").strip())
    if not raw:
        return None
    if slots is None:
        slots = int(os.environ.get("SKYTPU_ADAPTER_SLOTS", "8") or 8)
    if rank is None:
        rank = int(os.environ.get("SKYTPU_ADAPTER_RANK", "16") or 16)
    cat = AdapterCatalog(cfg, n_adapters=max(slots, 2), rank=rank,
                         device=device)
    cat.register_entries(raw)
    return cat
