"""The port's mesh, sharding rules and env bootstrap
(``skypilot_tpu_torch/parallel/``) against the JAX package's. In one
process: mesh shapes, every llama leaf's spec under every rule table,
the moments' shardings, the env topology, the multislice layout, the
kv heads a tp rank reads, and a one-rank mesh's train step against the
plain step. On CPU ranks (gloo), against the JAX package's 8-device
CPU mesh: each rank's local shards against the JAX array's shard on
the same device index, and float32 steps of llama3-tiny from one JAX
state on ``(dp 2, fsdp 2, tp 2)``, ``(fsdp 8)``, two virtual slices of
four and ``(tp 4)`` (kv heads replicated, packed documents), plus the
two-process rendezvous from the gang driver's env. Each group of ranks
runs once per module (a fixture); the ranks import no JAX and trade
numpy trees through ``.npz``. ``train.run`` over ranks is in
``test_torch_train_mesh.py``."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import torch_ranks
from skypilot_tpu.data import input_pipeline as jip
from skypilot_tpu.models import llama as jl
from skypilot_tpu.parallel import distributed as jdist
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import sharding as jsh
from skypilot_tpu.runtime import constants
from skypilot_tpu.runtime.driver import build_job_env
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.ops import attention as tattn
from skypilot_tpu_torch.parallel import distributed as tdist
from skypilot_tpu_torch.parallel import mesh as tmesh
from skypilot_tpu_torch.parallel import sharding as tsh
from skypilot_tpu_torch.train import checkpoints as tck
from skypilot_tpu_torch.train import trainer as tt

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

MESHES = {"dp2-fsdp2-tp2": dict(dp=2, fsdp=2, tp=2), "fsdp8": dict(fsdp=8),
          "tp4": dict(tp=4)}
RULES = {"default": "DEFAULT_RULES", "act": "ACT_RULES",
         "infer_tp": "INFER_TP_RULES"}
CONFIGS = ("llama3-tiny", "llama3-1b")


@pytest.fixture()
def one_rank_group():
    """A one-rank gloo group for the test (``make_mesh`` opens it), gone
    afterwards so no other test in this worker sees a group."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# -- mesh shapes ----------------------------------------------------------


SHAPE_CASES = [(8, {}), (8, dict(tp=2)), (8, dict(tp=2, dp=2)),
               (6, dict(tp=2)), (4, dict(sp=2)), (8, dict(ep=2, pp=2)),
               (1, {})]


@pytest.mark.parametrize("n,kw", SHAPE_CASES,
                         ids=[f"{n}-{kw}" for n, kw in SHAPE_CASES])
def test_default_shape_for_matches_reference(n, kw):
    got, want = tmesh.default_shape_for(n, **kw), jmesh.default_shape_for(
        n, **kw)
    assert got.as_dict() == want.as_dict()
    assert got.size == want.size == n
    assert tmesh.MESH_AXES == jmesh.MESH_AXES


@pytest.mark.parametrize("n,kw", [(8, dict(tp=3)), (6, dict(tp=4)),
                                  (8, dict(dp=3, tp=2))])
def test_default_shape_for_refuses_what_the_reference_refuses(n, kw):
    with pytest.raises(ValueError) as want:
        jmesh.default_shape_for(n, **kw)
    with pytest.raises(ValueError) as got:
        tmesh.default_shape_for(n, **kw)
    assert str(got.value) == str(want.value)


def test_make_mesh_over_one_rank(one_rank_group):
    """With no group, ``make_mesh`` opens a one-rank one: a size-1 mesh
    (all ranks on fsdp by default), and the reference's ValueError for a
    shape the world does not fill."""
    m = tmesh.make_mesh(device="cpu")
    assert dist.get_world_size() == 1
    assert m.mesh_dim_names == ("fsdp",) and m.size() == 1
    assert tmesh.mesh_shape(m).as_dict() == tmesh.MeshShape().as_dict()
    with pytest.raises(ValueError, match="needs 2 devices, got 1"):
        tmesh.make_mesh(tmesh.MeshShape(tp=2), "cpu")
    with pytest.raises(ValueError, match="needs 4 devices, got 1"):
        tmesh.make_mesh({"dp": 2, "fsdp": 2, "other": 5}, "cpu")


def test_mesh_keeps_the_axes_above_size_one():
    assert tmesh.mesh_axes(tmesh.MeshShape(dp=2, fsdp=2, tp=2)) == (
        "dp", "fsdp", "tp")
    assert tmesh.mesh_axes(tmesh.MeshShape(pp=2, sp=2)) == ("pp", "sp")
    assert tmesh.mesh_axes(tmesh.MeshShape()) == ("fsdp",)


# -- sharding rules -------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("config", CONFIGS)
def test_specs_match_the_reference_partition_specs(config, rules,
                                                   mesh_name):
    """Every llama leaf's spec (``spec_for`` through
    ``logical_to_sharding``, with the divisibility guard) equals the
    reference's ``PartitionSpec`` on the same mesh."""
    shape = tmesh.MeshShape(**MESHES[mesh_name])
    jm = jmesh.make_mesh(jmesh.MeshShape(**MESHES[mesh_name]),
                         jax.devices()[:shape.size])
    jcfg, tcfg = jl.CONFIGS[config], tl.CONFIGS[config]
    assert tl.param_logical_axes(tcfg) == jl.param_logical_axes(jcfg)
    jshapes = jax.eval_shape(lambda: jl.init_params(jax.random.key(0),
                                                    jcfg))
    tshapes = tl.init_params(tcfg, torch.Generator(), device="meta")
    want = dict(_leaves(jsh.logical_to_sharding(
        jl.param_logical_axes(jcfg), jm, getattr(jsh, RULES[rules]),
        shapes=jshapes)))
    got = dict(_leaves(tsh.logical_to_sharding(
        tl.param_logical_axes(tcfg), shape, getattr(tsh, RULES[rules]),
        shapes=tshapes)))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].spec == tuple(want[name].spec), name
    # The same table resolves the same way without the guard, too.
    for name, axes in _leaves(tl.param_logical_axes(tcfg)):
        assert tsh.spec_for(axes, getattr(tsh, RULES[rules])) == tuple(
            jsh.spec_for(axes, getattr(jsh, RULES[rules]))), name


def test_rule_tables_are_the_reference_tables():
    for name in RULES.values():
        assert getattr(tsh, name) == getattr(jsh, name)


def test_placements_pin_the_major_to_minor_order():
    """``("dp", "fsdp")`` on one dim is ``Shard(d)`` on both mesh dims,
    dp (the outer one) splitting first: JAX's major-to-minor tuple.
    A size-1 axis splits nothing; an out-of-order tuple has no DTensor
    placement and is refused."""
    m = tmesh.MeshShape(dp=2, fsdp=2, tp=2)
    assert tsh.placements((("dp", "fsdp"), None), m) == (
        Shard(0), Shard(0), Replicate())
    assert tsh.placements((None, "fsdp", "tp", None), m) == (
        Replicate(), Shard(1), Shard(2))
    assert tsh.placements((("dp", "fsdp"), "sp"), tmesh.MeshShape(fsdp=8)) \
        == (Shard(0),)
    assert tsh.placements(("tp", "fsdp"), tmesh.MeshShape()) == (
        Replicate(),)
    with pytest.raises(ValueError, match="not in mesh order"):
        tsh.placements((("fsdp", "dp"),), m)


def _adam(node):
    """The optax chain's Adam entry (the one with ``mu``)."""
    if hasattr(node, "mu"):
        return node
    for child in node if isinstance(node, (tuple, list)) else ():
        found = _adam(child)
        if found is not None:
            return found
    return None


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_moment_shardings_match_the_reference(mesh_name):
    """The trainer's moments take their parameter's sharding by name;
    the reference's ``opt_state_shardings`` looks them up by shape, and
    finds the same specs for llama."""
    shape = tmesh.MeshShape(**MESHES[mesh_name])
    jm = jmesh.make_mesh(jmesh.MeshShape(**MESHES[mesh_name]),
                         jax.devices()[:shape.size])
    jcfg, tcfg = jl.CONFIGS["llama3-tiny"], tl.CONFIGS["llama3-tiny"]
    jopt = jt.state_shardings(jcfg, jm)["opt_state"]
    adam = _adam(jopt)
    got = tt.state_shardings(tcfg, shape)["opt_state"]
    for moment in ("mu", "nu"):
        want = dict(_leaves(getattr(adam, moment)))
        mine = dict(_leaves(got[moment]))
        assert mine.keys() == want.keys()
        for name in want:
            assert mine[name].spec == tuple(want[name].spec), (moment, name)


def test_constrain_is_the_identity_without_a_mesh():
    c = tsh.make_constrain(None)
    x = torch.ones(2, 3)
    assert c(x, ("batch", "seq")) is x


# -- the env contract ------------------------------------------------------


ENV_CASES = [
    {},
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:8476", "JAX_NUM_PROCESSES": "4",
     "JAX_PROCESS_ID": "3"},
    {"SKYTPU_NUM_HOSTS": "2", "SKYTPU_HOST_ID": "1"},
    {"JAX_NUM_PROCESSES": "4", "SKYTPU_NUM_HOSTS": "2",
     "JAX_PROCESS_ID": "2", "SKYTPU_HOST_ID": "1",
     "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"},
]
_ENV_KEYS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
             "JAX_PROCESS_ID", "SKYTPU_NUM_HOSTS", "SKYTPU_HOST_ID",
             "MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID")


@pytest.mark.parametrize("env", ENV_CASES, ids=range(len(ENV_CASES)))
def test_topology_from_env_matches_reference(env, monkeypatch):
    for k in _ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(tdist.topology_from_env()) == \
        dataclasses.asdict(jdist.topology_from_env())


def test_initialize_from_env_is_a_no_op_for_one_process(monkeypatch):
    for k in _ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    topo = tdist.initialize_from_env("cpu")
    assert topo.num_processes == 1 and not dist.is_initialized()
    assert tdist.world_size() == 1 and tdist.rank() == 0
    assert tdist.backend_for("cpu") == "gloo"


# -- multislice --------------------------------------------------------------


def _ids(jax_mesh):
    return np.vectorize(lambda d: d.id)(jax_mesh.devices)


@pytest.mark.parametrize("kw", [dict(dp=2, fsdp=2, tp=2), dict(dp=2, fsdp=4),
                                None])
def test_virtual_multislice_layout_matches_reference(kw):
    """Two virtual slices of four: rank i sits where JAX device i sits
    (dp indexes the slice)."""
    want = jmesh.make_multislice_mesh(
        jmesh.MeshShape(**kw) if kw else None, n_slices=2)
    got = tmesh.multislice_ranks(tmesh.slice_groups([0] * 8, 2),
                                 tmesh.MeshShape(**kw) if kw else None)
    np.testing.assert_array_equal(got.numpy(), _ids(want))


def test_multislice_groups_ranks_by_slice_id():
    groups = tmesh.slice_groups([1, 1, 0, 0, 1, 1, 0, 0])
    assert groups == [[2, 3, 6, 7], [0, 1, 4, 5]]
    assert tmesh.slice_groups([0, 1], n_slices=4) == [[0], [1]]
    ranks = tmesh.multislice_ranks(groups, tmesh.MeshShape(dp=2, tp=4))
    assert ranks[0, 1, 0, 0, 0].tolist() == [0, 1, 4, 5]


@pytest.mark.parametrize("kw", [dict(dp=3, fsdp=2), dict(dp=2, fsdp=3)])
def test_multislice_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        jmesh.make_multislice_mesh(jmesh.MeshShape(**kw), n_slices=2)
    with pytest.raises(ValueError) as got:
        tmesh.multislice_ranks(tmesh.slice_groups([0] * 8, 2),
                               tmesh.MeshShape(**kw))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.slice_groups([0] * 8, 3)
    with pytest.raises(ValueError, match="equally sized"):
        tmesh.multislice_ranks([[0, 1], [2]])


# -- the kv heads a tp rank reads -------------------------------------------


KV_CASES = [(4, 2, 4), (4, 2, 2), (8, 2, 4), (8, 2, 8), (12, 4, 4),
            (12, 4, 6), (16, 8, 4), (6, 2, 6)]


@pytest.mark.parametrize("H,KVH,tp", KV_CASES,
                         ids=[f"H{h}-KV{k}-tp{t}" for h, k, t in KV_CASES])
def test_rank_kv_heads_feed_the_kernel_rule(H, KVH, tp):
    """With q heads split over tp and kv heads whole, each rank's slice
    lets the kernel's own rule (local q head j reads local kv head
    ``j // (n_local / kv_local)``) find kv head ``h // (H / KVH)`` for
    global q head h."""
    kv = torch.arange(KVH, dtype=torch.float32)[None, None, :, None]
    n_local, rep = H // tp, H // KVH
    for r in range(tp):
        mine = tattn._rank_kv_heads(kv, r, n_local, rep)
        assert n_local % mine.shape[2] == 0
        group = n_local // mine.shape[2]
        for j in range(n_local):
            assert mine[0, 0, j // group, 0] == (r * n_local + j) // rep


# -- a one-rank mesh --------------------------------------------------------


def test_one_rank_mesh_step_equals_the_plain_step(one_rank_group,
                                                  tmp_path):
    """llama3-tiny in float32 on a one-rank CPU mesh: two steps give the
    plain step's losses, grad norms and parameters bit for bit (every
    tensor is whole, the local products are the plain ones), and a
    checkpoint of the mesh state restores into the plain state bit for
    bit."""
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                              dtype=torch.float32, xent_chunk=12)
    tc = tt.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4)
    mesh = tmesh.make_mesh(tmesh.MeshShape(), "cpu")
    plain = tt.create_train_state(cfg, tc, "cpu", seed=3)
    sharded = tt.create_train_state(cfg, tc, "cpu", seed=3, mesh=mesh)
    batch = tt.synthetic_batch(cfg, 2, 33, seed=1, device="cpu")
    step_plain = tt.make_train_step(cfg, tc)
    step_mesh = tt.make_train_step(cfg, tc, mesh=mesh)
    for _ in range(2):
        _, mp = step_plain(plain, batch)
        _, mm = step_mesh(sharded, batch)
        for k in ("loss", "accuracy", "grad_norm"):
            assert type(mm[k]) is torch.Tensor
            assert torch.equal(mp[k], mm[k]), k
    for a, b in zip(tt._layer_leaves(plain["params"]),
                    tt._layer_leaves(sharded["params"])):
        assert torch.equal(a, b.full_tensor())
    with tck.CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(2, sharded)
        mgr.wait()
        into = tt.create_train_state(cfg, tc, "cpu", seed=9)
        mgr.restore(into)
    for a, b in zip(tt._layer_leaves(into["params"]),
                    tt._layer_leaves(plain["params"])):
        assert torch.equal(a, b)
    assert into["step"] == 2 and into["opt_state"]["count"] == 2


# -- groups of CPU ranks ----------------------------------------------------


TC = dict(learning_rate=1e-2, warmup_steps=6, total_steps=20,
          grad_clip=0.5)
STEPS = 2
XENT_CHUNK = 12          # 32 targets into chunks of 12: one padded chunk

# name -> (mesh kwargs, virtual slices or None, batch kind). The 8-rank
# group runs the first three, the 4-rank group the last.
MESH8 = {"dp2-fsdp2-tp2": (dict(dp=2, fsdp=2, tp=2), None, "plain"),
         "fsdp8": (dict(fsdp=8), None, "plain"),
         "multislice": (dict(dp=2, fsdp=2, tp=2), 2, "plain")}
MESH4 = {"tp4": (dict(tp=4), None, "packed")}

_RANK_BODY = """
import dataclasses
from types import SimpleNamespace
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import sharding as sh
from skypilot_tpu_torch.train import trainer as tt

job = json.load(open(os.path.join(DIR, "job.json")))
cfg = dataclasses.replace(llama.CONFIGS["llama3-tiny"], dtype=torch.float32,
                          xent_chunk=job["xent_chunk"])
tc = tt.TrainConfig(**job["tc"])
src = unflatten(dict(np.load(os.path.join(DIR, "state.npz"))))
jax_like = {"params": src["params"], "step": src["step"],
            "opt_state": (SimpleNamespace(count=src["count"], mu=src["mu"],
                                          nu=src["nu"]),)}
out = {}
for name, (kw, slices, kind) in job["meshes"].items():
    shape = mesh_lib.MeshShape(**kw)
    mesh = (mesh_lib.make_multislice_mesh(shape, n_slices=slices,
                                          device="cpu")
            if slices else mesh_lib.make_mesh(shape, "cpu"))
    out[name + "/ranks"] = mesh.mesh.numpy()
    # The slimmed serving tree (embed and norms, plus a tensor the axes
    # tree lacks) under the inference rules, walked by key.
    slim = {"embed": torch.from_numpy(src["params"]["embed"]),
            "final_norm": torch.from_numpy(src["params"]["final_norm"]),
            "extra": torch.arange(8.0)}
    for path, t in leaves(sh.shard_tree_subset(
            slim, llama.param_logical_axes(cfg), mesh, sh.INFER_TP_RULES)):
        out[f"{name}/subset/{path}"] = t.to_local().numpy().copy()
    state = tt.train_state_from_numpy(jax_like, cfg, "cpu", mesh=mesh)
    for path, t in leaves(state["params"]):
        out[f"{name}/before/{path}"] = t.to_local().numpy().copy()
    for moment in ("mu", "nu"):
        for path, t in leaves(state["opt_state"][moment]):
            out[f"{name}/{moment}_placements/{path}"] = np.array(
                str(tuple(t.placements)))
    batch = {k: torch.from_numpy(v) for k, v in src["batch"][kind].items()}
    step = tt.make_train_step(cfg, tc, mesh=mesh)
    for i in range(job["steps"]):
        _, m = step(state, batch)
        for k in ("loss", "grad_norm", "accuracy"):
            out[f"{name}/{k}{i}"] = m[k].numpy()
    for path, t in leaves(state["params"]):
        out[f"{name}/after/{path}"] = t.to_local().numpy().copy()
        full = t.full_tensor()          # a collective: every rank joins
        if RANK == 0:
            out[f"{name}/full/{path}"] = full.numpy()
np.savez(os.path.join(DIR, f"rank{RANK}.npz"), **out)
"""


def _cfg():
    return dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32,
                               xent_chunk=XENT_CHUNK)


def _batches():
    rng = np.random.default_rng(5)
    plain = {"tokens": rng.integers(0, 512, (8, 33)).astype(np.int32)}
    docs = list(jip.synthetic_doc_stream(60, 512, mean_len=12, seed=0))
    packed = {k: np.asarray(v) for k, v in next(
        jip.packed_batches(docs, 8, 33)).items()}
    return {"plain": plain, "packed": packed}


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _warm_state(cfg, batch):
    """Three unsharded JAX steps from seed 0: a mid-warmup state whose
    Adam moments are warm, so the compared steps are not the first
    ones (where a gradient near zero makes Adam's update ±lr on its
    sign alone)."""
    tc = jt.TrainConfig(**TC)
    step = jt.make_train_step(cfg, tc, None)
    state = jt.create_train_state(cfg, tc, None, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        state, _ = step(state, jb)
    return _np(state)


def _jax_leg(cfg, warm, kw, slices, batch, n):
    """The JAX step on the same mesh: the device-indexed shards of the
    parameters before and after, the per-step loss and grad norm, the
    whole parameters after, and the moments' specs."""
    tc = jt.TrainConfig(**TC)
    shape = jmesh.MeshShape(**kw)
    mesh = (jmesh.make_multislice_mesh(shape, n_slices=slices) if slices
            else jmesh.make_mesh(shape, jax.devices()[:n]))
    shardings = jt.state_shardings(cfg, mesh)
    state = jax.device_put(jax.tree.map(jnp.asarray, warm), shardings)

    def shards(params):
        return {path: {s.device.id: np.array(s.data)
                       for s in leaf.addressable_shards}
                for path, leaf in _paths(params)}

    slim = {"embed": warm["params"]["embed"],
            "final_norm": warm["params"]["final_norm"],
            "extra": np.arange(8.0, dtype=np.float32)}
    out = {"ranks": np.vectorize(lambda d: d.id)(mesh.devices),
           "subset": shards(jsh.shard_tree_subset(
               slim, jl.param_logical_axes(cfg), mesh, jsh.INFER_TP_RULES)),
           "before": shards(state["params"]),
           "mu_specs": {p: tuple(s.spec) for p, s in _paths(
               _adam(shardings["opt_state"]).mu)}}
    step = jt.make_train_step(cfg, tc, mesh)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        metrics.append({k: float(m[k])
                        for k in ("loss", "grad_norm", "accuracy")})
    out["metrics"] = metrics
    out["after"] = shards(state["params"])
    out["full"] = {p: np.array(v) for p, v in _paths(state["params"])}
    return out


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _run_group(tmp_dir, n, meshes):
    cfg = _cfg()
    batches = _batches()
    warm = _warm_state(cfg, batches["plain"])
    adam = _adam(warm["opt_state"])
    flat = torch_ranks.flatten({
        "params": warm["params"], "mu": adam.mu, "nu": adam.nu,
        "count": np.asarray(adam.count), "step": np.asarray(warm["step"]),
        "batch": batches})
    np.savez(os.path.join(tmp_dir, "state.npz"), **flat)
    with open(os.path.join(tmp_dir, "job.json"), "w") as f:
        json.dump({"tc": TC, "steps": STEPS, "xent_chunk": XENT_CHUNK,
                   "meshes": meshes}, f)
    torch_ranks.run_ranks(n, _RANK_BODY, tmp_dir)
    ranks = [dict(np.load(os.path.join(tmp_dir, f"rank{r}.npz")))
             for r in range(n)]
    want = {name: _jax_leg(cfg, warm, kw, slices, batches[kind], n)
            for name, (kw, slices, kind) in meshes.items()}
    return ranks, want


@pytest.fixture(scope="module")
def group8(tmp_path_factory):
    return _run_group(tmp_path_factory.mktemp("ranks8"), 8, MESH8)


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    return _run_group(tmp_path_factory.mktemp("ranks4"), 4, MESH4)


CASES = [("group8", n) for n in MESH8] + [("group4", n) for n in MESH4]
IDS = [n for _, n in CASES]


def _group(request, which):
    return request.getfixturevalue(which)


@pytest.mark.parametrize("which,name", CASES, ids=IDS)
def test_rank_sits_where_the_jax_device_sits(request, which, name):
    ranks, want = _group(request, which)
    np.testing.assert_array_equal(ranks[0][f"{name}/ranks"],
                                  want[name]["ranks"].squeeze())
    if name == "multislice":
        # dp indexes the slice: slice 0 holds ranks 0-3.
        assert set(ranks[0][f"{name}/ranks"][0].flat) == {0, 1, 2, 3}


@pytest.mark.parametrize("which,name", CASES, ids=IDS)
def test_local_shards_equal_the_jax_shards(request, which, name):
    """Rank r's shard of every parameter, as distributed from the whole
    state, is bit for bit the JAX array's shard on device r; after the
    steps it is within 1e-5 of it."""
    ranks, want = _group(request, which)
    for r, got in enumerate(ranks):
        for path, by_device in want[name]["before"].items():
            np.testing.assert_array_equal(got[f"{name}/before/{path}"],
                                          by_device[r], err_msg=path)
        for path, by_device in want[name]["after"].items():
            np.testing.assert_allclose(got[f"{name}/after/{path}"],
                                       by_device[r], rtol=0, atol=1e-5,
                                       err_msg=path)


@pytest.mark.parametrize("which,name", CASES, ids=IDS)
def test_shard_tree_subset_matches_the_reference(request, which, name):
    """``shard_tree_subset`` of a slimmed tree under the inference rules
    (vocab over tp, norms and a tensor without axes replicated): rank
    r's shard is the JAX array's shard on device r."""
    ranks, want = _group(request, which)
    for r, got in enumerate(ranks):
        for path, by_device in want[name]["subset"].items():
            np.testing.assert_array_equal(got[f"{name}/subset/{path}"],
                                          by_device[r], err_msg=path)


@pytest.mark.parametrize("which,name", CASES, ids=IDS)
def test_sharded_steps_match_the_jax_steps(request, which, name):
    """float32, two steps from one warm JAX state: loss and grad norm
    within 1e-5 relative on every rank, the whole parameters after the
    steps within 1e-5 of max|Δ| (the two sides sum their shards in
    other orders)."""
    ranks, want = _group(request, which)
    for i, m in enumerate(want[name]["metrics"]):
        for got in ranks:
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(got[f"{name}/{k}{i}"]),
                                           m[k], rtol=1e-5,
                                           err_msg=f"{k} step {i}")
    worst = max(np.abs(ranks[0][f"{name}/full/{p}"] - w).max()
                for p, w in want[name]["full"].items())
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("which,name", CASES, ids=IDS)
def test_sharded_accuracy_matches_the_jax_accuracy(request, which, name):
    """The accuracy metric of each step equals the reference's on the
    same mesh, where the vocab is split over tp (tp alone and with dp
    and fsdp) and where it is not: each row's argmax is the first index
    that reaches its max, ties included, without gathering the vocab."""
    ranks, want = _group(request, which)
    for i, m in enumerate(want[name]["metrics"]):
        for got in ranks:
            np.testing.assert_allclose(float(got[f"{name}/accuracy{i}"]),
                                       m["accuracy"], rtol=0, atol=1e-6,
                                       err_msg=f"step {i}")


@pytest.mark.parametrize("which,name", CASES, ids=IDS)
def test_moments_take_their_parameters_placements(request, which, name):
    """The DTensor moments' placements are those of the reference's
    ``opt_state_shardings`` specs on the same mesh."""
    ranks, want = _group(request, which)
    shape = tmesh.MeshShape(**(MESH8 | MESH4)[name][0])
    for path, spec in want[name]["mu_specs"].items():
        expect = str(tsh.placements(spec, shape))
        for moment in ("mu", "nu"):
            assert str(ranks[0][f"{name}/{moment}_placements/{path}"]) == \
                expect, (moment, path)


_RENDEZVOUS = """
import torch.distributed as dist
assert dist.get_world_size() == 2, dist.get_world_size()
assert RANK == TOPO.process_id, (RANK, TOPO)
x = torch.tensor([float(RANK + 1)])
dist.all_reduce(x)
print("RESULT", RANK, TOPO.num_processes, float(x), flush=True)
"""


def _meta(n_hosts):
    hosts = [{"host_id": i, "node_id": i, "worker_id": 0,
              "internal_ip": f"10.0.{i}.1", "workspace": None,
              "kind": "ssh"} for i in range(n_hosts)]
    return {"provider": "gcp", "cluster_name": "ms", "zone": "z",
            "head_host_id": 0, "hosts": hosts}


def test_two_processes_rendezvous_from_the_injected_env(tmp_path):
    """Two CPU processes join one gloo group using only the env the gang
    driver injects (its coordinator pointed at a local port): world 2,
    each rank its ``JAX_PROCESS_ID``."""
    port = torch_ranks.free_port()
    meta = _meta(2)
    envs = []
    for hid in (0, 1):
        env = build_job_env(meta, 1, meta["hosts"][hid])
        env[constants.ENV_COORDINATOR] = f"127.0.0.1:{port}"
        envs.append(torch_ranks.rank_env(2, hid, port, env))
    code = torch_ranks.PROLOGUE + _RENDEZVOUS
    outs = torch_ranks.spawn([[sys.executable, "-c", code, str(tmp_path)]]
                             * 2, envs)
    results = sorted(o.strip().splitlines()[-1] for o, _ in outs)
    assert results == ["RESULT 0 2 3.0", "RESULT 1 2 3.0"]
