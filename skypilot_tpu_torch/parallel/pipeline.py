"""Pipeline parallelism: microbatches through stage-stacked llama layers,
the GPipe and 1F1B schedules, over the ``pp`` mesh axis.

Counterpart of ``skypilot_tpu/parallel/pipeline.py``, with its config
(:class:`PipelineConfig`, ``CONFIGS["pp-tiny"]``), parameter layout (the
llama's per-layer weights stacked ``[n_stages, L / n_stages, ...]``, the
stage dim first, logical axis ``"stage"`` -> ``pp``) and model surface
(``init_params``, ``param_logical_axes``, ``forward_hidden``,
``forward``, ``loss_fn``), so the trainer, checkpoints and ``train.run``
take it as they take llama.

The schedule is the reference's tick loop: at tick t stage s holds
microbatch ``t - s``; after ``M + S - 1`` ticks every microbatch has
passed every stage. Each (tick, stage) application runs under
``llama.remat`` with the model's policy (the reference's
``jax.checkpoint(tick)``). The (tick, stage) pairs that hold no
microbatch (the bubble's warm-up and drain slots, which the reference
computes and discards) are skipped: the loss and gradients are the
same.

* **GPipe**: every microbatch's output is kept, and the loss runs over
  the reassembled batch.
* **1F1B**: each microbatch's loss is taken in the tick that drains it,
  and only scalar accumulators cross ticks.

Where the reference gets the backward by differentiating its tick scan
(the 1F1B interleave falls out of the reversed program), the port
schedules the backward itself, because autograd runs a graph's backward
only after its whole forward: 1F1B backpropagates each microbatch in
the tick that drains it (so only the microbatches in flight hold saved
activations, flat in the microbatch count), GPipe after the last tick.
:func:`loss_fn` returns a loss whose backward hands the gradients so
computed to the parameters it was given (``_Gradients``), so the
trainer's ``autograd.grad(loss, params)`` reads them as it reads any
model's.

On a mesh with ``pp`` above 1 each rank holds its stage's layers (the
stage dim split over pp) and runs its stage on a DTensor mesh of the
other axes; activations move one stage forward and their gradients one
stage back by ``batch_isend_irecv``/``send``/``recv`` on the pp group
(the reference's concatenate on a pp-split dim, which XLA lowers to
neighbour permutes). Parameters held on every stage (the embedding,
the final norm, the head) are used where the reference's program uses
them (stage 0, the last stage) and their gradients summed over pp.
Without pp above 1 the stages run in turn on each rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from skypilot_tpu_torch import DeviceLike
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding as sh

Params = Dict[str, Any]

# The trainer runs this model over a device mesh, pp included.
RUNS_ON_MESH = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig(llama.LlamaConfig):
    """Llama config with a pipelined decoder stack.

    ``schedule``: ``"gpipe"`` (all microbatch outputs kept, the loss over
    the reassembled batch) or ``"1f1b"`` (each microbatch's loss in the
    tick that drains it; saved activations flat in ``n_microbatches``).
    Under either, a synchronous flat pipeline idles (S-1)/(M+S-1) of
    its ticks; 1F1B's gain is memory, which lets M rise."""

    n_stages: int = 2
    n_microbatches: int = 4
    schedule: str = "gpipe"

    def __post_init__(self):
        if self.n_layers % self.n_stages:
            raise ValueError(f"n_layers={self.n_layers} not divisible by "
                             f"n_stages={self.n_stages}")
        if self.schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline schedule "
                             f"{self.schedule!r} (gpipe | 1f1b)")

    @property
    def layers_per_stage(self) -> int:
        return self.n_layers // self.n_stages


CONFIGS: Dict[str, PipelineConfig] = {
    "pp-tiny": PipelineConfig(vocab_size=512, d_model=128, n_layers=4,
                              n_heads=4, n_kv_heads=2, d_ff=256,
                              max_seq_len=256, n_stages=2,
                              n_microbatches=4),
}


# ---------------------------------------------------------------------------
# Stage-stacked parameters
# ---------------------------------------------------------------------------

def _to_stages(blocks: Params, n_stages: int) -> Params:
    """[L, ...] stacked per-layer weights -> [n_stages, L/stages, ...]."""
    return {k: w.reshape(n_stages, w.shape[0] // n_stages, *w.shape[1:])
            for k, w in blocks.items()}


def init_params(cfg: PipelineConfig, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """llama's random parameters (``llama.init_params``), the blocks
    stage-stacked."""
    params = llama.init_params(cfg, generator, device, dtype)
    params["blocks"] = _to_stages(params["blocks"], cfg.n_stages)
    return params


def params_from_numpy(tree: Dict[str, Any], cfg: PipelineConfig,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's stage-stacked tree (numpy leaves) -> tensors."""
    return llama.params_from_numpy(tree, cfg, device, dtype)


def param_logical_axes(cfg: PipelineConfig) -> Params:
    axes = llama.param_logical_axes(cfg)
    axes["blocks"] = {k: ("stage",) + t for k, t in axes["blocks"].items()}
    return axes


# ---------------------------------------------------------------------------
# Where this rank's stages live
# ---------------------------------------------------------------------------

def _sub_mesh(mesh):
    """The mesh of the axes other than pp (None when pp is the only
    one)."""
    names = [a for a in mesh.mesh_dim_names if a != "pp"]
    return mesh[tuple(names)] if names else None


def _sub_placements(t: DTensor, lead: int) -> list:
    """``t``'s placements on the mesh of the axes other than pp, for a
    part of it without its ``lead`` leading dims."""
    i = t.device_mesh.mesh_dim_names.index("pp")
    pl = [p for j, p in enumerate(t.placements) if j != i]
    return [Shard(p.dim - lead) if p.is_shard() else p for p in pl]


class _Plan:
    """One call's layout: the stages this rank runs, the parameters they
    read as leaves of this call's own (on a pp mesh: this rank's part,
    on the mesh of the other axes), whose ``.grad`` the schedule fills,
    and the constraint over that mesh. A stage-stacked block gives one
    leaf a layer, as the plain llama step has: its layers' gradients
    are tensors of their own (indexing one stacked leaf would give each
    layer's backward a zero-filled gradient the size of the stack)."""

    def __init__(self, params: Params, cfg: PipelineConfig, constrain):
        self.cfg = cfg
        mesh = getattr(constrain, "mesh", None)
        self.pp = mesh_lib.mesh_shape(mesh).pp if mesh is not None else 1
        self.leaves: List[torch.Tensor] = [
            t for t in _tensors(params) if t.requires_grad]
        self.train = torch.is_grad_enabled() and bool(self.leaves)
        # id of a caller's leaf -> (this call's leaves of it, a block)
        self.local: Dict[int, tuple] = {}
        self.sub = None
        if self.pp == 1:
            self.stages = list(range(cfg.n_stages))
            self.constrain = constrain or sh.identity
        else:
            if cfg.n_stages != self.pp:
                raise ValueError(f"n_stages={cfg.n_stages} on a "
                                 f"pp={self.pp} mesh: one stage a pp rank")
            self.mesh = mesh
            self.group = mesh.get_group("pp")
            self.stage = mesh.get_local_rank("pp")
            self.stages = [self.stage]
            self.sub = _sub_mesh(mesh)
            self.constrain = (sh.make_constrain(self.sub, constrain.rules)
                              if self.sub is not None else sh.identity)
        self.params = self._localize(params)

    def _take(self, t, local, lead: int, placements=None):
        """This call's leaf of the caller's ``t``, whose values here are
        ``local``; for a block (``lead`` leading dims stacking layers) a
        list of one leaf a layer. ``placements``: each part's on the mesh
        of the other axes (a pp mesh)."""
        if lead:
            flat = (local if lead == 1
                    else local.reshape(-1, *local.shape[lead:]))
            parts = [flat[i].detach() for i in range(flat.shape[0])]
        else:
            parts = [local.detach()]
        if placements is not None:
            parts = [DTensor.from_local(p, self.sub, placements,
                                        run_check=False) for p in parts]
        if self.train and t.requires_grad:
            for p in parts:
                p.requires_grad_()
            self.local[id(t)] = (parts, bool(lead))
        return parts if lead else parts[0]

    def _localize(self, tree, blocks: bool = False):
        """The tree with each tensor replaced by this call's leaves of it
        (:meth:`_take`): the same values, or on a pp mesh this rank's
        part on the mesh of the other axes (a stage-stacked block: its
        own stage's layers). A block comes as the stacked tensor [S, L /
        S, ...] or the trainer's rows of it [L / S, ...] (a list); its
        layers come out as one list, in order."""
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = self._localize(v, blocks or k == "blocks")
            elif self.pp == 1 and isinstance(v, list):
                out[k] = [p for t in v for p in self._take(
                    t, t, 1 if blocks else 0)]
            elif self.pp == 1:
                out[k] = self._take(v, v, 2 if blocks else 0)
            else:
                t = v[0] if isinstance(v, list) else v
                local = t.to_local() if isinstance(t, DTensor) else t
                lead = 2 if blocks else 0
                out[k] = self._take(
                    t, local, lead, _sub_placements(t, lead)
                    if self.sub is not None else None)
        return out

    def stage_params(self, s: int) -> Params:
        """Stage s's layers {name: [leaf of each layer]}."""
        blocks = self.params["blocks"]
        if self.pp == 1:
            n = self.cfg.layers_per_stage
            return {k: w[s * n:(s + 1) * n] for k, w in blocks.items()}
        return blocks

    def grad_leaves(self, head_only: bool = False) -> List[torch.Tensor]:
        """This call's leaves; ``head_only``: those outside the
        stage-stacked blocks."""
        return [p for parts, block in self.local.values()
                if not (head_only and block) for p in parts]

    def peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def caller_grads(self) -> list:
        """The gradient of each of the caller's leaves (zeros where none
        arose), a block's its layers' stacked. On a pp mesh from this
        rank's own: a block's is its stage's row of the pp-split
        gradient; anything else's is summed over pp (the stages that used
        it)."""
        out = []
        for t in self.leaves:
            parts, block = self.local[id(t)]
            gs = [torch.zeros_like(p) if p.grad is None else p.grad
                  for p in parts]
            if self.pp > 1:
                gs = [g.redistribute(p.device_mesh, p.placements).to_local()
                      if isinstance(g, DTensor) else g
                      for g, p in zip(gs, parts)]
            if not block:
                g = gs[0]
            elif self.pp == 1:
                g = torch.stack(gs).reshape(t.shape)
            else:
                g = torch.stack(gs).unsqueeze(0)
            if self.pp == 1:
                out.append(g)
                continue
            if not block:
                g = g.contiguous()
                dist.all_reduce(g, group=self.group)
            out.append(DTensor.from_local(g, self.mesh, t.placements,
                                          run_check=False)
                       if isinstance(t, DTensor) else g)
        return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_of(t):
    return (t.to_local() if isinstance(t, DTensor) else t).contiguous()


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

def _stage_apply(cfg: PipelineConfig, stage: Params, x, cos, sin,
                 attention, constrain):
    """One stage's ``layers_per_stage`` decoder layers. x: [b, S, D]."""
    for i in range(cfg.layers_per_stage):
        x = llama._layer_hidden(cfg, x, {k: w[i] for k, w in stage.items()},
                                cos, sin, attention, None, constrain)
    return x


class _Run:
    """One pass of the tick loop over a batch: the microbatches, and the
    stage inputs and outputs a pp mesh keeps for its backward."""

    def __init__(self, plan: _Plan, tokens, mask, attention):
        cfg = self.cfg = plan.cfg
        self.plan = plan
        self.tokens = sh.whole(tokens)
        self.mask = None if mask is None else sh.whole(mask)
        B, S = self.tokens.shape
        M = cfg.n_microbatches
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        self.b, self.S, self.M = B // M, S, M
        positions = torch.arange(S, device=self.tokens.device)
        self.cos, self.sin = (plan.constrain(t, ("seq", None)) for t in
                              llama.rope_frequencies(cfg, positions))
        self.attention = attention
        self.x_in: Dict[int, tuple] = {}    # m -> (input, its local leaf)
        self.y: Dict[int, torch.Tensor] = {}     # m -> output (pp mesh)

    def micro(self, t, m):
        return None if t is None else t[m * self.b:(m + 1) * self.b]

    def embed(self, m):
        p, c = self.plan.params, self.plan.constrain
        tok = c(self.micro(self.tokens, m), ("batch", "seq"))
        table = c(p["embed"].to(self.cfg.dtype), ("vocab", "embed"))
        return c(llama._lookup(tok, table), ("batch", "seq", "embed"))

    def apply(self, s, x):
        return llama.remat(self.cfg, _stage_apply, self.cfg,
                           self.plan.stage_params(s), x, self.cos,
                           self.sin, self.attention, self.plan.constrain)

    def head_loss(self, h, tokens, mask):
        """(loss, accuracy, denom) of the final norm, head and
        cross-entropy over the last stage's output h."""
        p, c = self.plan.params, self.plan.constrain
        h = llama.rms_norm(h, p["final_norm"], self.cfg.norm_eps)
        return llama.xent_metrics(
            p, h, c(tokens, ("batch", "seq")),
            None if mask is None else c(mask, ("batch", "seq")), self.cfg,
            constrain=c)

    def accumulate(self, outputs, inputs, grad_outputs=None,
                   head_only: bool = False):
        """The backward of ``outputs`` into the leaves' ``.grad`` (added in
        place, a parameter at a time) and into ``inputs`` (leaves too),
        whose gradients it returns. ``head_only`` stops at ``inputs``
        (here the last stage's outputs, not leaves), the stages' leaves
        left to their waves."""
        leaves = self.plan.grad_leaves(head_only)
        if not head_only:
            torch.autograd.backward(outputs, grad_tensors=grad_outputs,
                                    inputs=leaves + inputs)
            return [x.grad for x in inputs]
        got = torch.autograd.grad(outputs, leaves + inputs,
                                  grad_outputs=grad_outputs,
                                  allow_unused=True)
        for t, g in zip(leaves, got[:len(leaves)]):
            if g is not None:
                t.grad = g if t.grad is None else t.grad + g
        return got[len(leaves):]


def _ticks(run: _Run, on_drain, after_tick=None) -> None:
    """The tick loop: at tick t stage s runs microbatch t - s (pairs with
    no microbatch are skipped); on a pp mesh the activations move one
    stage at the start of each tick. ``on_drain(m, y)`` takes each
    microbatch's last-stage output in the tick that drains it;
    ``after_tick(t)`` runs at the end of each tick."""
    plan, M = run.plan, run.M
    last = run.cfg.n_stages - 1
    acts: Dict[int, torch.Tensor] = {}
    for t in range(M + last):
        if plan.pp > 1:
            _exchange(run, t)
        for s in plan.stages:
            m = t - s
            if not 0 <= m < M:
                continue
            if s == 0:
                x = run.embed(m)
            elif plan.pp == 1:
                x = acts.pop(m)
            else:
                x = run.x_in[m][0]
            y = run.apply(s, x)
            if s == last:
                on_drain(m, y)
            elif plan.pp == 1:
                acts[m] = y
            else:
                run.y[m] = y
        if after_tick is not None:
            after_tick(t)


def _act_like(run: _Run):
    """An empty activation shard [b, S, D] in this rank's layout, and its
    placements on the mesh of the other axes (None without one)."""
    plan, cfg = run.plan, run.cfg
    whole = torch.zeros((run.b, run.S, cfg.d_model), dtype=cfg.dtype,
                        device=run.tokens.device)
    laid = plan.constrain(whole, ("batch", "seq", "embed"))
    if isinstance(laid, DTensor):
        return torch.empty_like(laid.to_local()), laid.placements
    return torch.empty_like(laid), None


def _exchange(run: _Run, t: int) -> None:
    """Tick t's move on a pp mesh: this stage's output of tick t - 1 to
    the next stage, the previous stage's into this one (one
    ``batch_isend_irecv``)."""
    plan, M, s = run.plan, run.M, run.plan.stage
    ops = []
    m_out, m_in = t - 1 - s, t - s
    if s < run.cfg.n_stages - 1 and 0 <= m_out < M:
        y = run.y[m_out] if plan.train else run.y.pop(m_out)
        ops.append(dist.P2POp(dist.isend, _local_of(y.detach()),
                              plan.peer(s + 1), plan.group))
    buf = None
    if s > 0 and 0 <= m_in < M:
        buf, placements = _act_like(run)
        ops.append(dist.P2POp(dist.irecv, buf, plan.peer(s - 1), plan.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if buf is not None:
        if plan.train:
            buf.requires_grad_()
        x = (DTensor.from_local(buf, plan.sub, placements, run_check=False)
             if placements is not None else buf)
        run.x_in[m_in] = (x, buf)


def _wave(run: _Run, m: int, last=None) -> None:
    """Microbatch m's backward through the stages of a pp mesh, last to
    first. The last stage starts from ``last`` (outputs, grad_outputs);
    every other stage takes its output's gradient from the next one.
    Each accumulates its parameters' gradients and sends its input's
    gradient back one stage."""
    plan, s = run.plan, run.plan.stage
    if last is not None:
        outputs, grad_out = last
    else:
        y = run.y.pop(m)
        g = torch.empty_like(_local_of(y.detach()))
        dist.recv(g, plan.peer(s + 1), group=plan.group)
        if isinstance(y, DTensor):
            g = DTensor.from_local(g, y.device_mesh, y.placements,
                                   run_check=False)
        outputs, grad_out = y, g
    if s == 0:
        run.accumulate(outputs, [], grad_out)
        return
    buf = run.x_in.pop(m)[1]
    gx = run.accumulate(outputs, [buf], grad_out)[0]
    if gx is None:
        gx = torch.zeros_like(buf)
    dist.send(gx.contiguous(), plan.peer(s - 1), group=plan.group)


def _scalars(run: _Run, loss, acc, denom):
    """(loss, accuracy, denom) as whole float32 scalars on every rank; on
    a pp mesh broadcast from the last stage (the others pass None)."""
    dev = run.tokens.device
    vals = torch.stack([torch.zeros((), device=dev) if x is None
                        else sh.whole(x).detach().float().reshape(())
                        for x in (loss, acc, denom)])
    if run.plan.pp > 1:
        dist.broadcast(vals, run.plan.peer(run.cfg.n_stages - 1),
                       group=run.plan.group)
    return list(vals)


def _run(params: Params, batch: Dict[str, torch.Tensor], cfg: PipelineConfig,
         attention, constrain):
    """The loss and metrics of ``batch`` under ``cfg.schedule``, and,
    when grad is enabled and ``params`` has leaves that require it, the
    loss that hands them their gradients (:class:`_Gradients`)."""
    plan = _Plan(params, cfg, constrain)
    run = _Run(plan, batch["tokens"], batch.get("mask"), attention)
    last = cfg.n_stages - 1
    holds_loss = plan.pp == 1 or plan.stage == last
    loss = acc = denom = None
    if cfg.schedule == "1f1b":
        # The denominator is the mask's alone, known before any loss.
        ones = torch.ones((run.b * run.M, run.S - 1),
                          device=run.tokens.device)
        mask = ones if run.mask is None else run.mask[:, :-1].float()
        denom = sum(run.micro(mask, m).sum().clamp_min(1.0)
                    for m in range(run.M))
        total = denom.clamp_min(1.0)
        sums = {"loss": 0.0, "acc": 0.0}

        def on_drain(m, y):
            part_loss, part_acc, d = run.head_loss(
                y, run.micro(run.tokens, m), run.micro(run.mask, m))
            part = sh.whole(part_loss * d / total)
            sums["loss"] = sums["loss"] + part.detach()
            sums["acc"] = sums["acc"] + sh.whole(part_acc * d / total).detach()
            if not plan.train:
                return
            if plan.pp == 1:
                run.accumulate(part, [])
            else:
                _wave(run, m, (part, None))

        def after_tick(t):
            # The stages before the last join the wave of the
            # microbatch the last stage drained in this tick.
            m = t - last
            if 0 <= m < run.M:
                _wave(run, m)

        _ticks(run, on_drain, after_tick if (
            plan.pp > 1 and plan.train and not holds_loss) else None)
        if holds_loss:
            loss, acc = sums["loss"], sums["acc"]
    else:
        outs: Dict[int, torch.Tensor] = {}
        _ticks(run, outs.__setitem__)
        if holds_loss:
            ys = [outs[m] for m in range(run.M)]
            loss, acc, denom = run.head_loss(torch.cat(ys, dim=0),
                                             run.tokens, run.mask)
            loss = sh.whole(loss)
            if plan.train and plan.pp == 1:
                run.accumulate(loss, [])
            elif plan.train:
                g_ys = run.accumulate(loss, ys, head_only=True)
                for m in reversed(range(run.M)):
                    _wave(run, m, (ys[m], g_ys[m]))
        elif plan.train:
            for m in reversed(range(run.M)):
                _wave(run, m)
    loss_v, acc_v, denom_v = _scalars(run, loss, acc, denom)
    metrics = {"loss": loss_v, "accuracy": acc_v, "tokens": denom_v}
    if not plan.train:
        return loss_v, metrics
    return (_Gradients.apply(loss_v, plan.caller_grads(), *plan.leaves),
            metrics)


class _Gradients(torch.autograd.Function):
    """The loss, whose backward hands each parameter the gradient the
    schedule computed (times the incoming gradient)."""

    @staticmethod
    def forward(ctx, loss, grads, *leaves):
        ctx.grads = grads
        return loss.clone()

    @staticmethod
    def backward(ctx, g):
        scale = float(g)
        return (None, None) + tuple(grad if scale == 1.0 else grad * scale
                                    for grad in ctx.grads)


# ---------------------------------------------------------------------------
# The model surface
# ---------------------------------------------------------------------------

def forward_hidden(params: Params, tokens: torch.Tensor, cfg: PipelineConfig,
                   constrain=None, attention=None) -> torch.Tensor:
    """[B, S] ids -> final-norm hidden [B, S, D] through the pipelined
    stack (the microbatches in order, reassembled). On a pp mesh the
    last stage's result comes back whole on every rank."""
    with torch.no_grad():
        plan = _Plan(params, cfg, constrain)
        run = _Run(plan, tokens, None, attention)
        outs: Dict[int, torch.Tensor] = {}
        _ticks(run, outs.__setitem__)
        x = None
        if plan.pp == 1 or plan.stage == cfg.n_stages - 1:
            x = llama.rms_norm(torch.cat([outs[m] for m in range(run.M)]),
                               plan.params["final_norm"], cfg.norm_eps)
        if plan.pp == 1:
            return x
        whole = torch.empty((run.b * run.M, run.S, cfg.d_model),
                            dtype=cfg.dtype, device=run.tokens.device)
        if x is not None:
            whole.copy_(sh.whole(x))
        dist.broadcast(whole, plan.peer(cfg.n_stages - 1), group=plan.group)
        return whole


def forward(params: Params, tokens: torch.Tensor, cfg: PipelineConfig,
            constrain=None) -> torch.Tensor:
    """[B, S] ids -> float32 logits [B, S, vocab]."""
    with torch.no_grad():
        x = forward_hidden(params, tokens, cfg, constrain)
        head = llama.lm_head(params, cfg)
        if isinstance(x, DTensor) != isinstance(head, DTensor):
            x, head = sh.whole(x), sh.whole(head)
        return (x @ head.to(cfg.dtype)).float()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: PipelineConfig, attention=None, constrain=None):
    """Next-token cross-entropy through the pipelined stack, under
    ``cfg.schedule``; both schedules compute the same loss and
    gradients. Returns (loss, {"loss", "accuracy", "tokens"}) as plain
    0-dim float32 tensors, the same on every rank; with grad enabled
    and parameters that require it, the loss's backward gives them their
    gradients (module docstring). Packed sequences are refused, as the
    reference refuses them."""
    if batch.get("segment_ids") is not None:
        raise ValueError(
            "packed sequences (segment_ids) are not supported by the "
            "pipeline adapter; use the llama or moe model")
    return _run(params, batch, cfg, attention, constrain)
