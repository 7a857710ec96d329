"""The port's pipeline adapter (``skypilot_tpu_torch/parallel/
pipeline.py``) against the JAX package's, float32, on the same numpy
inputs: the config checks, the pipelined forward against the plain
stack, the logical axes, 1F1B against GPipe (loss and each gradient,
both against ``jax.grad`` of the reference), 1F1B's saved activations flat
in the microbatch count; and on eight CPU ranks (gloo) the reference
fixtures' meshes ``pp2-dp2-tp2`` and ``pp2-fsdp2-tp2``: the pp-mesh
loss against the unsharded JAX loss, two train steps under each
schedule against the JAX steps on the same mesh, and a checkpoint saved
on the pp mesh restored on one rank. Each mesh's ranks run once per module (a
fixture) and import no JAX."""

import dataclasses
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_ranks
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import pipeline as jpl
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.parallel import pipeline as tpl
from skypilot_tpu_torch.train import checkpoints as tck
from skypilot_tpu_torch.train import trainer as tt

torch.set_num_threads(1)

TC = dict(learning_rate=1e-2, warmup_steps=6, total_steps=20, grad_clip=0.5)
STEPS = 2
MESHES = {"pp2-fsdp2-tp2": dict(pp=2, fsdp=2, tp=2),
          "pp2-dp2-tp2": dict(pp=2, dp=2, tp=2)}


def _jcfg(**kw):
    return dataclasses.replace(jpl.CONFIGS["pp-tiny"], dtype=jnp.float32,
                               **kw)


def _tcfg(**kw):
    return dataclasses.replace(tpl.CONFIGS["pp-tiny"], dtype=torch.float32,
                               **kw)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _params():
    return _np(jpl.init_params(jax.random.key(0), _jcfg()))


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def test_layers_divisible_check():
    for kw in (dict(n_layers=5, n_stages=2), dict(schedule="zb")):
        with pytest.raises(ValueError) as want:
            jpl.PipelineConfig(**kw)
        with pytest.raises(ValueError) as got:
            tpl.PipelineConfig(**kw)
        assert str(got.value) == str(want.value)
    assert tpl.CONFIGS["pp-tiny"].layers_per_stage == 2


def test_pipelined_matches_sequential():
    """The pipelined forward == the plain llama stack on the same weights
    (the stage-stacked tree reshaped), and == the JAX pipelined forward."""
    cfg = _tcfg()
    params = tpl.params_from_numpy(_params(), cfg, "cpu")
    lcfg = tl.LlamaConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tl.LlamaConfig)})
    flat = dict(params, blocks={k: w.reshape(-1, *w.shape[2:])
                                for k, w in params["blocks"].items()})
    tokens = _tokens(4, 32, 1)
    got = tpl.forward(params, torch.from_numpy(tokens), cfg)
    want = tl.forward(flat, torch.from_numpy(tokens), lcfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    ref = jpl.forward(jax.tree.map(jnp.asarray, _params()),
                      jnp.asarray(tokens), _jcfg())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_param_axes_match_shapes():
    cfg = tpl.CONFIGS["pp-tiny"]
    params = tpl.init_params(cfg, torch.Generator(), device="meta")
    axes = tpl.param_logical_axes(cfg)
    assert axes == jpl.param_logical_axes(jpl.CONFIGS["pp-tiny"])
    for k, w in params["blocks"].items():
        assert w.dim() == len(axes["blocks"][k])
        assert w.shape[:2] == (cfg.n_stages, cfg.layers_per_stage)
        assert axes["blocks"][k][0] == "stage"
    want = jax.eval_shape(lambda: jpl.init_params(jax.random.key(0),
                                                  jpl.CONFIGS["pp-tiny"]))
    for k, w in params["blocks"].items():
        assert tuple(w.shape) == want["blocks"][k].shape


LEAVES = ["embed", "final_norm", "lm_head"] + [
    f"blocks/{k}" for k in ("ln1", "ln2", "w_down", "w_gate", "w_up", "wk",
                            "wo", "wq", "wv")]


def _leaf(tree, name):
    for part in name.split("/"):
        tree = tree[part]
    return tree


@pytest.fixture(scope="module")
def against_jax():
    """Both schedules' loss, metrics and gradients (batch 8 x 32, 4
    microbatches, a mask), the port's and the reference's ``loss_fn`` and
    ``jax.grad``: {schedule: (port, jax)}, each (loss, metrics, grads by
    leaf name)."""
    tokens = _tokens(8, 32, 3)
    mask = (np.random.default_rng(4).random((8, 32)) > 0.2).astype(
        np.float32)
    out = {}
    for schedule in ("gpipe", "1f1b"):
        jcfg, tcfg = _jcfg(schedule=schedule), _tcfg(schedule=schedule)
        jp = jax.tree.map(jnp.asarray, _params())
        jb = {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(mask)}
        (jloss, jm), jg = jax.value_and_grad(
            lambda p: jpl.loss_fn(p, jb, jcfg), has_aux=True)(jp)
        params = tpl.params_from_numpy(_params(), tcfg, "cpu")
        leaves = [_leaf(params, n) for n in LEAVES]
        for t in leaves:
            t.requires_grad_()
        loss, m = tpl.loss_fn(params, {"tokens": torch.from_numpy(tokens),
                                       "mask": torch.from_numpy(mask)}, tcfg)
        grads = torch.autograd.grad(loss, leaves)
        out[schedule] = (
            (float(loss.detach()), {k: float(v) for k, v in m.items()},
             {n: g.numpy() for n, g in zip(LEAVES, grads)}),
            (float(jloss), {k: float(v) for k, v in jm.items()},
             {n: np.asarray(_leaf(jg, n)) for n in LEAVES}))
    return out


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_loss_matches_jax(against_jax, schedule):
    """Loss, accuracy and token count of each schedule against the
    reference's ``loss_fn``."""
    (loss, m, _), (jloss, jm, _) = against_jax[schedule]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(m["accuracy"], jm["accuracy"], atol=1e-6)
    assert m["tokens"] == jm["tokens"]


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_grads_match_jax(against_jax, schedule, leaf):
    """Each parameter's gradient under each schedule against ``jax.grad``
    of the reference's loss, within 1e-5 of its max."""
    (_, _, grads), (_, _, jgrads) = against_jax[schedule]
    w = jgrads[leaf]
    np.testing.assert_allclose(grads[leaf], w, rtol=0,
                               atol=1e-5 * np.abs(w).max())


def test_1f1b_matches_gpipe():
    """Both schedules give the same loss and gradients (the reference
    test's batch: 2 rows a microbatch)."""
    tokens = torch.from_numpy(_tokens(8, 32, 3))
    out = {}
    for schedule in ("gpipe", "1f1b"):
        cfg = _tcfg(schedule=schedule)
        params = tpl.params_from_numpy(_params(), cfg, "cpu")
        loss, m, grads = tt.grads_of(params, {"tokens": tokens}, cfg,
                                     model=tpl)
        out[schedule] = (loss, m, grads)
    (gl, gm, gg), (sl, sm, sg) = out["gpipe"], out["1f1b"]
    np.testing.assert_allclose(float(sl), float(gl), rtol=1e-6)
    assert float(sm["tokens"]) == float(gm["tokens"])
    for a, b in zip(gg, sg):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-6 * float(a.abs().max()))


def _saved_peak(schedule: str, m: int) -> int:
    """Peak bytes of activations saved for the backward while the loss
    and its gradients are computed (``saved_tensors_hooks``: each saved
    tensor counted from its packing until the graph that holds it is
    freed), microbatches of 2 rows, no remat."""
    cfg = _tcfg(schedule=schedule, n_microbatches=m, remat=False)
    params = tpl.params_from_numpy(_params(), cfg, "cpu")
    live = {"now": 0, "peak": 0}

    class Box:
        __slots__ = ("t", "__weakref__")

    def release(n):
        live["now"] -= n

    def pack(t):
        box = Box()
        box.t = t
        n = t.numel() * t.element_size()
        live["now"] += n
        live["peak"] = max(live["peak"], live["now"])
        weakref.finalize(box, release, n)
        return box

    tokens = torch.from_numpy(_tokens(2 * m, 64, 3))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda b: b.t):
        tt.grads_of(params, {"tokens": tokens}, cfg, model=tpl)
    return live["peak"]


def test_1f1b_saved_bytes_flat_in_the_microbatch_count():
    """GPipe keeps every microbatch's activations until its backward
    (they grow with M); 1F1B backpropagates each in the tick that drains
    it, so its peak stays flat as M goes from 4 to 16."""
    g4, g16 = _saved_peak("gpipe", 4), _saved_peak("gpipe", 16)
    s4, s16 = _saved_peak("1f1b", 4), _saved_peak("1f1b", 16)
    assert s16 <= s4 * 1.1, (s4, s16)
    assert g16 > 3 * g4, (g4, g16)
    assert g16 > 3 * s16, (g16, s16)


class _StackGradients(TorchDispatchMode):
    """Records the input shapes of every ``select_backward``: the
    zero-filled gradient of a whole tensor that one indexed row's
    backward builds."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.select_backward.default:
            self.shapes.append(tuple(args[1]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("via", ["trainer", "loss_fn"])
def test_stages_read_one_leaf_a_layer(via):
    """Each stage reads its layers as leaves of their own, from the
    trainer's stage rows [L/S, ...] and from the stacked tree [S, L/S,
    ...] alike, so no layer's backward builds a gradient the size of
    its stage (or of the stack), and each block's gradient is still the
    caller's shape."""
    cfg = _tcfg()
    params = tpl.params_from_numpy(_params(), cfg, "cpu")
    tokens = torch.from_numpy(_tokens(8, 32, 3))
    with torch.enable_grad():
        plan = tpl._Plan(dict(params, blocks={
            k: [w[s].clone().requires_grad_() for s in range(cfg.n_stages)]
            for k, w in params["blocks"].items()}), cfg, None)
    for s in range(cfg.n_stages):
        for k, layers in plan.stage_params(s).items():
            assert len(layers) == cfg.layers_per_stage, k
            for t in layers:
                assert t.is_leaf and t.requires_grad
                assert t.shape == params["blocks"][k].shape[2:]
    stacked = {(cfg.layers_per_stage,) + tuple(w.shape[2:])
               for w in params["blocks"].values()} | {
        tuple(w.shape) for w in params["blocks"].values()}
    with _StackGradients() as seen:
        if via == "trainer":
            _, _, grads = tt.grads_of(params, {"tokens": tokens}, cfg,
                                      model=tpl)
            want = [tuple(t.shape) for t in tt._layer_leaves(params)]
        else:
            leaves = [t.requires_grad_() for t in tpl._tensors(params)]
            loss, _ = tpl.loss_fn(params, {"tokens": tokens}, cfg)
            grads = torch.autograd.grad(loss, leaves)
            want = [tuple(t.shape) for t in leaves]
    assert [tuple(g.shape) for g in grads] == want
    assert not stacked & set(seen.shapes), seen.shapes


def test_packed_batches_are_refused():
    cfg = _tcfg()
    params = tpl.init_params(cfg, torch.Generator(), "cpu")
    batch = {"tokens": torch.zeros(4, 8, dtype=torch.int64),
             "segment_ids": torch.ones(4, 8, dtype=torch.int64)}
    with pytest.raises(ValueError, match="not supported by the pipeline"):
        tpl.loss_fn(params, batch, cfg)


# -- eight CPU ranks ---------------------------------------------------------


_RANK_BODY = """
import dataclasses
from types import SimpleNamespace
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import pipeline as pl
from skypilot_tpu_torch.parallel import sharding as sh
from skypilot_tpu_torch.train import checkpoints, trainer as tt

job = json.load(open(os.path.join(DIR, "job.json")))
src = unflatten(dict(np.load(os.path.join(DIR, "in.npz"))))
base = dataclasses.replace(pl.CONFIGS["pp-tiny"], dtype=torch.float32)
name = job["mesh"]
mesh = mesh_lib.make_mesh(mesh_lib.MeshShape(**job["meshes"][name]), "cpu")
out = {}
if job["loss"]:
    # The pp-mesh loss (no grad) against the unsharded one.
    params = pl.params_from_numpy(src["params"], base, "cpu")
    p = sh.distribute_tree(params, sh.logical_to_sharding(
        pl.param_logical_axes(base), mesh, sh.DEFAULT_RULES,
        shapes=params))
    batch = {"tokens": torch.from_numpy(src["loss_tokens"])}
    with torch.no_grad():
        for sched in ("gpipe", "1f1b"):
            cfg = dataclasses.replace(base, schedule=sched)
            loss, m = pl.loss_fn(p, batch, cfg,
                                 constrain=sh.make_constrain(mesh))
            out[f"loss/{sched}"] = loss.numpy()
            out[f"tokens/{sched}"] = m["tokens"].numpy()
# Train steps under both schedules.
st = src["train"]
for sched in ("gpipe", "1f1b"):
    cfg = dataclasses.replace(base, schedule=sched)
    jax_like = {"params": st["params"], "step": st["step"],
                "opt_state": (SimpleNamespace(
                    count=st["count"], mu=st["mu"], nu=st["nu"]),)}
    state = tt.train_state_from_numpy(jax_like, cfg, "cpu", model=pl,
                                      mesh=mesh)
    out[f"{name}/{sched}/wq_placements"] = np.array(
        str(tuple(state["params"]["blocks"]["wq"].placements)))
    step = tt.make_train_step(cfg, tt.TrainConfig(**job["tc"]), model=pl,
                              mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in st["batch"].items()}
    for i in range(job["steps"]):
        _, m = step(state, batch)
        for key in ("loss", "grad_norm"):
            out[f"{name}/{sched}/{key}{i}"] = m[key].numpy()
    for path, t in leaves(state["params"]):
        full = t.full_tensor()
        if RANK == 0:
            out[f"{name}/{sched}/full/{path}"] = full.numpy()
    if job["ckpt"] and sched == "1f1b":
        with checkpoints.CheckpointManager(os.path.join(DIR, "ckpt")) as mgr:
            mgr.save(job["steps"], state)
            mgr.wait()
if RANK == 0:
    np.savez(os.path.join(DIR, "out.npz"), **out)
"""

# Each mesh's ranks run once: the pp-mesh loss beside pp2-dp2-tp2's
# steps, the checkpoint beside pp2-fsdp2-tp2's.
GROUPS = {"pp2-dp2-tp2": dict(loss=True, ckpt=False),
          "pp2-fsdp2-tp2": dict(loss=False, ckpt=True)}


def _adam(node):
    if hasattr(node, "mu"):
        return node
    for child in node if isinstance(node, (tuple, list)) else ():
        found = _adam(child)
        if found is not None:
            return found
    return None


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def inputs():
    """The parameters, the loss batch, a warm JAX state (three unsharded
    steps: Adam's moments warm) and its batch."""
    cfg = _jcfg()
    loss_tokens = _tokens(cfg.n_microbatches, 32, 5)
    train_batch = {"tokens": _tokens(cfg.n_microbatches * 2, 32, 6)}
    tc = jt.TrainConfig(**TC)
    warm = jt.create_train_state(cfg, tc, None, seed=0, model=jpl)
    step = jt.make_train_step(cfg, tc, None, model=jpl)
    jb = {k: jnp.asarray(v) for k, v in train_batch.items()}
    for _ in range(3):
        warm, _ = step(warm, jb)
    return _params(), loss_tokens, _np(warm), train_batch


def _group_run(tmp_path_factory, inputs, name):
    """One mesh's rank body on eight CPU ranks and the JAX legs on the
    same mesh: (port, jax, directory)."""
    tmp = tmp_path_factory.mktemp(name)
    params, loss_tokens, warm, train_batch = inputs
    adam = _adam(warm["opt_state"])
    np.savez(os.path.join(tmp, "in.npz"), **torch_ranks.flatten({
        "params": params, "loss_tokens": loss_tokens,
        "train": {"params": warm["params"], "mu": adam.mu, "nu": adam.nu,
                  "count": np.asarray(adam.count),
                  "step": np.asarray(warm["step"]), "batch": train_batch}}))
    with open(os.path.join(tmp, "job.json"), "w") as f:
        json.dump(dict(GROUPS[name], mesh=name, meshes=MESHES, tc=TC,
                       steps=STEPS), f)
    torch_ranks.run_ranks(8, _RANK_BODY, tmp,
                          timeout=torch_ranks.SLOW_TIMEOUT_S)
    port = dict(np.load(os.path.join(tmp, "out.npz")))
    want = {"loss": {}, "steps": {}}
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in train_batch.items()}
    tc = jt.TrainConfig(**TC)
    mesh = jmesh.make_mesh(jmesh.MeshShape(**MESHES[name]))
    for sched in ("gpipe", "1f1b"):
        c = _jcfg(schedule=sched)
        if GROUPS[name]["loss"]:
            want["loss"][sched] = float(jpl.loss_fn(
                jp, {"tokens": jnp.asarray(loss_tokens)}, c)[0])
        state = jax.device_put(jax.tree.map(jnp.asarray, warm),
                               jt.state_shardings(c, mesh, model=jpl))
        mstep = jt.make_train_step(c, tc, mesh, model=jpl)
        ms = []
        for _ in range(STEPS):
            state, m = mstep(state, jb)
            ms.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        want["steps"][sched] = (
            ms, {p: np.array(v) for p, v in _paths(state["params"])})
    return port, want, tmp


@pytest.fixture(scope="module")
def pp_dp(tmp_path_factory, inputs):
    return _group_run(tmp_path_factory, inputs, "pp2-dp2-tp2")


@pytest.fixture(scope="module")
def pp_fsdp(tmp_path_factory, inputs):
    return _group_run(tmp_path_factory, inputs, "pp2-fsdp2-tp2")


FIXTURE = {"pp2-dp2-tp2": "pp_dp", "pp2-fsdp2-tp2": "pp_fsdp"}


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_mesh_loss_matches_the_unsharded_jax_loss(pp_dp, schedule):
    port, want, _ = pp_dp
    np.testing.assert_allclose(float(port[f"loss/{schedule}"]),
                               want["loss"][schedule], rtol=1e-5)
    assert float(port[f"tokens/{schedule}"]) == 4 * 31


CASES = [(n, s) for n in MESHES for s in ("gpipe", "1f1b")]


@pytest.mark.parametrize("name,schedule", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_train_steps_on_the_pp_mesh_match_jax(request, name, schedule):
    """Two float32 steps from one warm JAX state on the pp mesh: loss and
    grad norm within 1e-5 relative of the JAX steps on the same mesh,
    the parameters after within 1e-5 of max|Δ|; the stage dim split
    over pp."""
    port, want, _ = request.getfixturevalue(FIXTURE[name])
    metrics, params = want["steps"][schedule]
    for i, m in enumerate(metrics):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(
                float(port[f"{name}/{schedule}/{k}{i}"]), m[k], rtol=1e-5,
                err_msg=f"{k} step {i}")
    worst = max(np.abs(port[f"{name}/{schedule}/full/{p}"] - w).max()
                for p, w in params.items())
    assert worst <= 1e-5, worst
    assert "Shard(dim=0)" in str(port[f"{name}/{schedule}/wq_placements"])


def test_pp_mesh_checkpoint_restores_on_one_rank(pp_fsdp):
    """The 1F1B state saved on ``pp2-fsdp2-tp2`` restores whole into a
    one-rank pipeline state, equal to the mesh run's parameters."""
    port, _, tmp = pp_fsdp
    cfg = _tcfg(schedule="1f1b")
    tc = tt.TrainConfig(**TC)
    state = tt.create_train_state(cfg, tc, "cpu", seed=9, model=tpl)
    with tck.CheckpointManager(os.path.join(tmp, "ckpt")) as mgr:
        mgr.restore(state)
    assert state["step"] == 3 + STEPS
    for path, t in _paths(state["params"]):
        np.testing.assert_array_equal(
            t.numpy(), port[f"pp2-fsdp2-tp2/1f1b/full/{path}"], err_msg=path)
