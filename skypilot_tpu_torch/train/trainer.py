"""The training step: loss, gradients, global-norm clip and AdamW.

Counterpart of ``skypilot_tpu/train/trainer.py``. The JAX
trainer chains ``optax.clip_by_global_norm`` and ``optax.adamw`` under
a warmup-cosine schedule; :func:`make_optimizer` writes that chain out
by hand so that the port's step follows optax 0.2.6 operation for
operation:

- clip: gradients stay as they are when ``||g|| < grad_clip``, else
  ``g / ||g|| * grad_clip`` (no epsilon);
- Adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, the
  count incremented before the bias correction, the update
  ``mu_hat / (sqrt(nu_hat) + 1e-8)`` from the uncast ``mu``; only the
  stored ``mu`` is cast to ``mu_dtype`` (with a bf16 ``mu``, ``b1`` is
  rounded to bf16 first, as JAX's weak-typed scalar is);
- weight decay on every parameter (norms and embeddings included);
- the learning rate of the pre-increment count, so step 0 moves
  nothing (the schedule starts at 0).

The state is ``{"params", "opt_state": {"count", "mu", "nu"}, "step"}``
with the parameters in the JAX package's stacked layout; the LoRA and
QLoRA steps (``train/lora.py``, ``train/qlora.py``) keep the same state
over an adapter tree. The step
updates parameters and moments in place (the JAX step returns new
arrays); it says so in its docstring.

Over a device mesh (``mesh=``; ``parallel/``) the state's tensors are
DTensors: the parameters laid out by ``llama.param_logical_axes`` under
the rule table (:func:`state_shardings`), each Adam moment by its
parameter's name (for llama, the same sharding the reference's lookup
by shape finds), the batch over ``("dp", "fsdp")``. The step's
activations follow the activation rules, the gradients are reduced to
their parameters' layouts (the dp all-reduce, the fsdp reduce-scatter),
and the optimizer runs unchanged on the DTensor leaves: its global norm
is the sum over every shard, and its in-place updates of a layer's row
reach the stacked DTensor's local shard. The parameters are drawn whole
from the seed and then distributed, so a run's parameters do not depend
on its mesh.

The step's metric families (``skytpu_train_*``), its ``train.step``
span and the compile watch around it are the reference's
(``skypilot_tpu/train/trainer.py``), under the same names, types,
labels and help. The histogram records the host-side step call: on the
card an eager step returns while its kernels may still be queued, and
the launch queue's back-pressure, not donated state, carries the call
toward the device step time (the help text is the reference's).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.observability import metrics as obs_metrics
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding as sh

STEP_SECONDS = obs_metrics.histogram(
    "skytpu_train_step_seconds",
    "Train step call latency (back-pressured by donated state to the "
    "device step time at steady state)")
TRAIN_STEPS = obs_metrics.counter(
    "skytpu_train_steps_total", "Train steps dispatched")
TRAIN_TOKENS = obs_metrics.counter(
    "skytpu_train_tokens_total", "Tokens dispatched to train steps")
TRAIN_TOKENS_PER_S = obs_metrics.gauge(
    "skytpu_train_tokens_per_second",
    "Dispatch-rate tokens/s, EMA over recent steps")
TRAIN_LOSS = obs_metrics.gauge(
    "skytpu_train_loss",
    "Most recently fetched training loss (see observe_loss)")
# Step-time regression pair for the SLO watchdog: the trailing median
# is the baseline, and the watchdog compares the windowed mean
# (histogram sum/count delta) against it.
TRAIN_STEP_LAST = obs_metrics.gauge(
    "skytpu_train_step_last_seconds",
    "Most recent post-compile train step wall time")
TRAIN_STEP_MEDIAN = obs_metrics.gauge(
    "skytpu_train_step_median_seconds",
    "Trailing median of recent post-compile step times (SLO regression "
    "baseline)")
_MEDIAN_WINDOW = 101


def observe_loss(loss: float) -> None:
    """Record a fetched loss into the gauge. Called where the train
    loop already pays the host sync (its logging cadence) — the step
    wrapper itself never forces a device fetch."""
    TRAIN_LOSS.set(float(loss))


def batch_tokens(batch) -> int:
    """Tokens in a batch: the ``tokens`` tensor's size, and 0 without one
    (an image batch ``{"images", "labels"}``), as the reference counts."""
    tokens = batch.get("tokens") if hasattr(batch, "get") else None
    return int(tokens.numel()) if isinstance(tokens, torch.Tensor) else 0


def _instrument_step(step_fn: Callable) -> Callable:
    ema = {"rate": 0.0, "warm": False}
    recent = collections.deque(maxlen=_MEDIAN_WINDOW)

    @functools.wraps(step_fn)
    def wrapper(state, batch):
        t0 = time.monotonic()
        t0_wall = time.time()
        out = step_fn(state, batch)
        dt = max(time.monotonic() - t0, 1e-9)
        TRAIN_STEPS.inc()
        tokens = batch_tokens(batch)
        if tokens:
            TRAIN_TOKENS.inc(tokens)
        if not ema["warm"]:
            # The first call pays the first-dispatch costs (kernel
            # library loads, cuBLAS handles, allocator growth); seeding
            # the EMA or the histogram with it would poison both.
            ema["warm"] = True
            return out
        STEP_SECONDS.observe(dt)
        recent.append(dt)
        TRAIN_STEP_LAST.set(dt)
        TRAIN_STEP_MEDIAN.set(statistics.median(recent))
        # Per-step trace span (joins an ambient trace when the run was
        # launched with one; the first call is skipped like above).
        tracing.record_span("train.step", t0_wall, t0_wall + dt,
                            attrs={"tokens": tokens} if tokens else None)
        if tokens:
            rate = tokens / dt
            ema["rate"] = (rate if ema["rate"] == 0.0
                           else 0.9 * ema["rate"] + 0.1 * rate)
            TRAIN_TOKENS_PER_S.set(ema["rate"])
        return out

    return wrapper

TrainState = Dict[str, Any]
_MU_DTYPES = {None: None, "bfloat16": torch.bfloat16,
              "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    # Storage dtype for Adam's first moment ("bfloat16" halves that
    # buffer). None keeps the params' dtype.
    mu_dtype: Optional[str] = None


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup,
    max(total, warmup + 1, 1), 0.1 lr)`` as a host function of the
    count, in float32 arithmetic in optax's order."""
    f32 = np.float32
    peak, end = tc.learning_rate, tc.learning_rate * 0.1
    warmup = tc.warmup_steps
    decay = max(tc.total_steps, warmup + 1, 1) - warmup
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:
            # linear_schedule(0, peak, warmup): (0 - peak) * frac + peak.
            c = min(max(count, 0), warmup)
            frac = f32(1) - f32(c) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay),
                                          dtype=f32))
        return float(f32(peak) * (f32(1 - alpha) * cos + f32(alpha)))

    return schedule


def _rows(w) -> list:
    """A stacked ``blocks`` tensor's rows (views), the unit that autograd
    and the optimizer work in; one whole leaf where the stacked dim is
    split over a mesh (the pipeline's stage dim over pp), whose rows
    live on other ranks."""
    if isinstance(w, DTensor) and any(
            p.is_shard() and p.dim == 0 for p in w.placements):
        return [w]
    return [w[i] for i in range(w.shape[0])]


def _layer_leaves(tree, like=None) -> List[torch.Tensor]:
    """Leaves of a parameter-shaped tree (nested dicts of tensors: the
    model's, or an adapter tree ``{target: {"a", "b"}}``) in the key
    order of ``like`` (default: the tree's own), depth first, so
    moments, gradients and parameters pair up by name however each
    tree's dicts were built; each stacked ``blocks`` tensor [L, ...]
    gives its L rows (:func:`_rows`). Any other tensor is one leaf."""
    like = tree if like is None else like
    leaves = []
    for k in like:
        if k == "blocks":
            for n in like[k]:
                leaves.extend(_rows(tree[k][n]))
        elif isinstance(like[k], dict):
            leaves.extend(_layer_leaves(tree[k], like[k]))
        else:
            leaves.append(tree[k])
    return leaves


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params, tc: TrainConfig) -> Dict[str, Any]:
    mu_dtype = _MU_DTYPES[tc.mu_dtype]
    return {"count": 0,
            "mu": _tree_map(lambda p: torch.zeros_like(
                p, dtype=mu_dtype or p.dtype), params),
            "nu": _tree_map(torch.zeros_like, params)}


def make_optimizer(tc: TrainConfig):
    """update(grads, opt_state, params) -> grad_norm: the clip + AdamW
    chain applied in place to the ``params`` tree and ``opt_state``.
    ``params`` is any nested tree: the model's, or an adapter tree
    (``train/lora.py``), which gets optax's chain unchanged (the clip
    over all its leaves, weight decay on every one: the reference
    passes no mask). ``grads`` lists one gradient per entry of
    ``_layer_leaves(params)`` (each layer's row of a stacked ``blocks``
    tensor on its own). Returns the global norm before clipping."""
    schedule = lr_schedule(tc)
    mu_dtype = _MU_DTYPES[tc.mu_dtype]
    b1, b2, wd = tc.beta1, tc.beta2, tc.weight_decay

    @torch.no_grad()
    def update(grads: List[torch.Tensor], opt_state: Dict[str, Any],
               params) -> torch.Tensor:
        mus = _layer_leaves(opt_state["mu"], params)
        nus = _layer_leaves(opt_state["nu"], params)
        g_norm = torch.sqrt(sum(g.square().sum() for g in grads))
        clip = g_norm >= tc.grad_clip     # optax keeps g when g_norm < max
        count = opt_state["count"]
        count_inc = count + 1
        bc1 = 1 - np.float32(b1) ** np.float32(count_inc)
        bc2 = 1 - np.float32(b2) ** np.float32(count_inc)
        step = -np.float32(schedule(count))
        for g, mu, nu, p in zip(grads, mus, nus, _layer_leaves(params)):
            g = torch.where(clip, (g / g_norm) * tc.grad_clip, g)
            # As the JAX program computes it: b1 takes mu's dtype (a
            # weak-typed scalar; 0.9 -> 0.8984375 for a bf16 mu), the
            # product stays float32, and m itself is not cast.
            b1_mu = float(torch.tensor(b1, dtype=mu.dtype))
            m = (1 - b1) * g + b1_mu * mu.float()
            nu.copy_((1 - b2) * g.square() + b2 * nu)
            u = (m / float(bc1)) / (torch.sqrt(nu / float(bc2)) + 1e-8)
            u = (u + wd * p) * float(step)
            p.add_(u)
            mu.copy_(m if mu_dtype is None else m.to(mu_dtype))
        opt_state["count"] = count_inc
        return g_norm

    return update


def _check_mesh_model(mesh, model) -> None:
    """A model module runs over a mesh where it says so
    (``RUNS_ON_MESH``): llama and the pipeline adapter; MoE and ViT not
    yet."""
    if mesh is not None and not getattr(model, "RUNS_ON_MESH", False):
        raise NotImplementedError(
            f"{model.__name__} over a device mesh is not ported yet (the "
            f"sharded MoE and ViT steps come with expert parallelism)")


def state_shardings(cfg: llama.LlamaConfig, mesh,
                    rules: sh.Rules = sh.DEFAULT_RULES, model=llama):
    """Shardings (``sharding.NamedSharding``) for the train state's
    tensors: ``{"params": ..., "opt_state": {"mu": ..., "nu": ...}}``,
    each moment its parameter's (:func:`opt_state_shardings`). The
    divisibility guard reads the parameters' shapes, taken on the meta
    device."""
    _check_mesh_model(mesh, model)
    shapes = model.init_params(cfg, torch.Generator(), device="meta")
    p_sh = sh.logical_to_sharding(model.param_logical_axes(cfg), mesh,
                                  rules, shapes=shapes)
    return {"params": p_sh, "opt_state": opt_state_shardings(p_sh)}


def opt_state_shardings(param_sh) -> Dict[str, Any]:
    """Shardings for the Adam state given the parameters': each moment
    takes its parameter's by name (the reference looks a moment's up by
    shape, which finds the same one for llama's tree); the count is a
    host integer."""
    return {"mu": param_sh, "nu": param_sh}


def shard_state(state: TrainState, cfg: llama.LlamaConfig, mesh,
                rules: sh.Rules = sh.DEFAULT_RULES,
                model=llama) -> TrainState:
    """``state`` (whole tensors, the same on every rank) with its
    parameters and moments distributed over ``mesh`` by
    :func:`state_shardings`; the identity for ``mesh=None``."""
    if mesh is None:
        return state
    shardings = state_shardings(cfg, mesh, rules, model)
    opt = state["opt_state"]
    return {"params": sh.distribute_tree(state["params"],
                                         shardings["params"]),
            "opt_state": dict(opt, **{
                k: sh.distribute_tree(opt[k], shardings["opt_state"][k])
                for k in ("mu", "nu")}),
            "step": state["step"]}


def create_train_state(cfg: llama.LlamaConfig, tc: TrainConfig,
                       device: DeviceLike = None, seed: int = 0,
                       model=llama, mesh=None,
                       rules: sh.Rules = sh.DEFAULT_RULES) -> TrainState:
    """Random ``cfg.param_dtype`` parameters of ``model`` (the module:
    ``models.llama``, ``models.moe`` or ``models.vit``) from ``seed``
    (drawn on ``device``), zero Adam moments, step 0. With ``mesh`` the
    parameters are drawn whole, then distributed by ``rules``."""
    _check_mesh_model(mesh, model)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init_params(cfg, gen, device=device)
    if mesh is not None:
        params = sh.distribute_tree(
            params, state_shardings(cfg, mesh, rules, model)["params"])
    return {"params": params, "opt_state": init_opt_state(params, tc),
            "step": 0}


def train_state_from_numpy(jax_state: Dict[str, Any],
                           cfg: llama.LlamaConfig,
                           device: DeviceLike = None,
                           model=llama, mesh=None,
                           rules: sh.Rules = sh.DEFAULT_RULES) -> TrainState:
    """A JAX train state with its leaves as numpy (``jax.tree.map(
    np.asarray, state)``) -> the port's. The optax chain's state is
    searched for its Adam entry (the one with ``count``, ``mu`` and
    ``nu``); mu keeps its dtype (bf16 under ``mu_dtype="bfloat16"``).
    With ``mesh``, distributed as :func:`shard_state` does."""
    device = resolve_device(device)
    state = {"params": model.params_from_numpy(jax_state["params"], cfg,
                                               device=device),
             "opt_state": opt_state_from_numpy(jax_state["opt_state"],
                                               device),
             "step": int(np.asarray(jax_state["step"]))}
    return shard_state(state, cfg, mesh, rules, model)


def opt_state_from_numpy(opt_state, device: DeviceLike = None
                         ) -> Dict[str, Any]:
    """An optax chain's state (numpy leaves) -> the port's
    ``{"count", "mu", "nu"}``: the chain is searched for its Adam entry
    (the one with ``count``, ``mu`` and ``nu``); each moment keeps its
    tree and its dtype (bf16 under ``mu_dtype="bfloat16"``)."""
    device = resolve_device(device)

    def find_adam(node):
        if all(hasattr(node, a) for a in ("count", "mu", "nu")):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                found = find_adam(child)
                if found is not None:
                    return found
        return None

    adam = find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")

    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":    # ml_dtypes: widen exactly
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)

    return {"count": int(np.asarray(adam.count)),
            "mu": _tree_map(leaf, adam.mu),
            "nu": _tree_map(leaf, adam.nu)}


def _grad_leaves(params) -> Tuple[Dict[str, Any], List[torch.Tensor]]:
    """Leaf tensors for autograd, in the order of ``_layer_leaves``, and
    a view of ``params`` built from them: each stacked block tensor as
    one leaf per layer (views of its rows, listed), so a layer's
    backward writes its own gradient instead of adding a zero-padded
    copy of the whole stack; every other tensor (an adapter's stacked
    ``a`` or ``b`` included: a few MB) as itself."""
    leaves: List[torch.Tensor] = []

    def leaf(w):
        t = w.detach().requires_grad_()
        leaves.append(t)
        return t

    def walk(tree):
        view = {}
        for k, w in tree.items():
            if k == "blocks":
                view[k] = {n: [leaf(r) for r in _rows(w)]
                           for n, w in w.items()}
            elif isinstance(w, dict):
                view[k] = walk(w)
            else:
                view[k] = leaf(w)
        return view

    return walk(params), leaves


def value_and_grads(params, loss_fn: Callable):
    """(loss, metrics, grads) of ``loss_fn(view) -> (loss, metrics)``
    with respect to ``params`` (any nested tree): ``view`` is
    ``params`` rebuilt from autograd leaves, and grads lists one tensor
    per entry of ``_layer_leaves(params)``. Over a mesh the loss and
    metrics come back whole (plain tensors) and each gradient in its
    leaf's layout: a partial sum is reduced (all-reduce over a
    replicated axis, reduce-scatter over a sharded one)."""
    view, leaves = _grad_leaves(params)
    loss, metrics = loss_fn(view)
    loss = sh.whole(loss)
    grads = list(torch.autograd.grad(loss, leaves))
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(p, DTensor) else g
             for g, p in zip(grads, leaves)]
    return (loss.detach(),
            {k: sh.whole(v).detach() for k, v in metrics.items()}, grads)


def grads_of(params, batch: Dict[str, torch.Tensor], cfg: llama.LlamaConfig,
             attention: Optional[Callable] = None, model=llama,
             constrain: Optional[Callable] = None):
    """(loss, metrics, grads) of ``model.loss_fn``: grads lists one
    tensor per entry of ``_layer_leaves(params)``, a stacked tensor's
    gradient per layer. ``constrain`` (llama over a mesh) lays out the
    activations (``sharding.make_constrain``)."""
    kw = {} if constrain is None else {"constrain": constrain}
    return value_and_grads(params, lambda p: model.loss_fn(
        p, batch, cfg, attention=attention, **kw))


def _batch_key_fn(args: tuple, kwargs: dict):
    """Shape-derived program identity for the trainer's compile watch:
    a new batch shape dispatches programs the warm-up never ran (new
    kernel tiles, new allocator blocks), and a mid-run shape change is
    exactly the silent first dispatch ``train.unexpected_compile``
    exists to expose."""
    batch = args[1] if len(args) > 1 else kwargs.get("batch")
    parts = []
    if hasattr(batch, "items"):
        for k in sorted(batch):
            shape = getattr(batch[k], "shape", None)
            if shape is not None:
                parts.append((k, "x".join(str(d) for d in shape)))
    return parts


def place_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """The batch laid out over ``mesh``: dim 0 over ``("dp", "fsdp")``
    (the reference's batch sharding), the rest whole. Every rank passes
    the same whole batch."""
    shape = mesh_lib.mesh_shape(mesh)
    degree = shape.dp * shape.fsdp
    out = {}
    for k, v in batch.items():
        if v.shape[0] % degree:
            raise ValueError(f"batch {k} of {v.shape[0]} rows does not "
                             f"split over dp x fsdp = {degree}")
        out[k] = sh.distribute(v, mesh, (("dp", "fsdp"),))
    return out


def make_train_step(cfg: llama.LlamaConfig, tc: TrainConfig,
                    watch=None, model=llama, mesh=None,
                    act_rules: sh.Rules = sh.ACT_RULES) -> Callable:
    """step(state, batch) -> (state, metrics) of ``model``'s loss
    (``models.llama``, ``models.moe`` or ``models.vit``). The step UPDATES
    ``state`` IN PLACE (parameters, moments, count and step) and
    returns the same dict; metrics are 0-dim tensors (the loss's own,
    e.g. "loss", "accuracy", "tokens", and "grad_norm" before clipping).

    With ``mesh`` (llama only) the state must be sharded
    (:func:`create_train_state` with the same mesh), the batch is placed
    by :func:`place_batch` and the activations by ``act_rules``; the
    metrics come back whole on every rank.

    The step is instrumented (the ``skytpu_train_*`` families and the
    ``train.step`` span, never a device fetch). ``watch`` is an
    optional ``flight.CompileWatch`` (the trainer's own, with
    ``event_name="train.unexpected_compile"``): the step is wrapped so
    every distinct batch-shape identity registers as a program, and a
    new one after warm-up emits the typed event."""
    _check_mesh_model(mesh, model)
    update = make_optimizer(tc)
    constrain = None if mesh is None else sh.make_constrain(mesh, act_rules)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if mesh is not None:
            batch = place_batch(batch, mesh)
        _, metrics, grads = grads_of(state["params"], batch, cfg,
                                     model=model, constrain=constrain)
        metrics["grad_norm"] = sh.whole(update(grads, state["opt_state"],
                                             state["params"]))
        state["step"] += 1
        return state, metrics

    if watch is not None:
        step = watch.wrap("train_step", step, key_fn=_batch_key_fn)
    return _instrument_step(step)


def synthetic_batch(cfg: llama.LlamaConfig, batch_size: int, seq_len: int,
                    seed: int = 0, device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """Uniform random tokens from a numpy generator."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch_size, seq_len),
                          dtype=np.int32)
    return {"tokens": torch.from_numpy(tokens).to(resolve_device(device))}
