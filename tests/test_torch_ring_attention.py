"""The port's context parallelism (``skypilot_tpu_torch/parallel/
ring_attention.py``, the llama's sp dispatch and zigzag layout) against
the JAX package's, on the reference fixtures' own meshes: eight CPU
ranks (gloo) run every case on ``dp2-sp2-tp2``, ``sp4-tp2`` and
``sp2-tp4`` (tp 4 divides the q heads but not the kv heads), and the
JAX functions run on the same meshes of its 8-device CPU mesh, on the
same numpy-seeded float32 inputs. Attention outputs within 1e-5,
gradients within 1e-4 (the reference tests' bounds), model losses
within 2e-4 relative. The ranks run once per module (a fixture) and
import no JAX; the step bodies are also checked in one process, block by
block, against plain attention."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from skypilot_tpu.models import llama as jl
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import ring_attention as jra
from skypilot_tpu.parallel import sharding as jsh
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.ops import attention as tattn
from skypilot_tpu_torch.parallel import ring_attention as tra

torch.set_num_threads(1)

MESHES = {"dp2-sp2-tp2": dict(dp=2, sp=2, tp=2), "sp4-tp2": dict(sp=4, tp=2),
          "sp2-tp4": dict(sp=2, tp=4)}
ATOL = 1e-5
GRAD_TOL = 1e-4

# name -> (mesh, scheme, causal, shapes (b, s, hq, hkv), segments, grads,
# zigzag layout)
ATTN_CASES = {
    "ring-causal": ("dp2-sp2-tp2", "ring", True, (2, 32, 4, 4), False,
                    False),
    "ring-full": ("dp2-sp2-tp2", "ring", False, (2, 32, 4, 4), False, False),
    "ring-sp4": ("sp4-tp2", "ring", True, (1, 64, 4, 4), False, False),
    "ring-grads-causal": ("dp2-sp2-tp2", "ring", True, (2, 16, 4, 4), False,
                          True),
    "ring-grads-full": ("dp2-sp2-tp2", "ring", False, (2, 16, 4, 4), False,
                        True),
    "gqa": ("dp2-sp2-tp2", "ring", True, (2, 32, 4, 2), False, False),
    "gqa-grads": ("dp2-sp2-tp2", "ring", True, (2, 16, 4, 2), False, True),
    "seg-causal": ("dp2-sp2-tp2", "ring", True, (2, 32, 4, 4), True, False),
    "seg-full": ("dp2-sp2-tp2", "ring", False, (2, 32, 4, 4), True, False),
    "seg-grads": ("dp2-sp2-tp2", "ring", True, (2, 16, 4, 4), True, True),
    "seg-gqa-sp4": ("sp4-tp2", "ring", True, (1, 64, 4, 2), True, False),
    "ulysses": ("dp2-sp2-tp2", "ulysses", True, (2, 32, 4, 4), False, False),
    "ulysses-seg": ("dp2-sp2-tp2", "ulysses", True, (2, 32, 4, 4), True,
                    False),
    "ulysses-grads": ("dp2-sp2-tp2", "ulysses", True, (2, 16, 4, 4), True,
                      True),
    "zigzag-sp2": ("dp2-sp2-tp2", "zigzag", True, (2, 32, 4, 4), False,
                   False),
    "zigzag-sp4": ("sp4-tp2", "zigzag", True, (2, 32, 4, 4), False, False),
    "zigzag-grads": ("dp2-sp2-tp2", "zigzag", True, (2, 16, 4, 4), False,
                     True),
    "zigzag-gqa-seg-sp4": ("sp4-tp2", "zigzag", True, (1, 64, 4, 2), True,
                           False),
    "nondivisible": ("dp2-sp2-tp2", "ring", True, (3, 32, 3, 3), False,
                     False),
    "tp-divides-q-not-kv": ("sp2-tp4", "ring", True, (2, 32, 8, 2), False,
                            False),
}

# name -> (mesh, kind, seq, zigzag rules)
MODEL_CASES = {
    "forward-sp": ("dp2-sp2-tp2", "forward", 64, False),
    "packed-loss-sp": ("dp2-sp2-tp2", "packed", 64, False),
    "zigzag-loss": ("dp2-sp2-tp2", "packed", 64, True),
    "zigzag-nondivisible": ("dp2-sp2-tp2", "forward", 66, True),
    "odd-seq": ("dp2-sp2-tp2", "forward", 65, False),
}
TC = dict(learning_rate=1e-2, warmup_steps=6, total_steps=20, grad_clip=0.5)
STEPS = 2


def _segments(b, s, seed=5):
    """The reference fixture's packed ids: contiguous, increasing, a
    padded tail of 0."""
    rng = np.random.RandomState(seed)
    out = np.zeros((b, s), np.int32)
    for i in range(b):
        pos, sid = 0, 1
        while pos < s - 2:
            length = rng.randint(3, max(4, s // 3))
            out[i, pos:pos + length] = sid
            pos += length
            sid += 1
    return out


def _attn_inputs(name, case, seed):
    _, _, _, (b, s, hq, hkv), seg, _ = case
    rng = np.random.default_rng(seed)
    out = {"q": rng.standard_normal((b, s, hq, 8), np.float32),
           "k": rng.standard_normal((b, s, hkv, 8), np.float32),
           "v": rng.standard_normal((b, s, hkv, 8), np.float32),
           "w": rng.standard_normal((b, s, hq, 8), np.float32)}
    if seg:
        out["seg"] = _segments(b, s)
    return out


def _jax_attn(case, x, meshes):
    """The JAX function's output (and gradients of sum(o * w)) on its
    mesh; zigzag cases permute in and unpermute out, as the reference
    tests do."""
    mesh_name, scheme, causal, _, _, grads = case
    mesh = meshes[mesh_name]
    n = mesh.shape["sp"]
    seg = jnp.asarray(x["seg"]) if "seg" in x else None

    def f(q, k, v):
        if scheme == "zigzag":
            zs = None if seg is None else jra.zigzag_permute(seg, n)
            o = jra.zigzag_ring_attention(
                jra.zigzag_permute(q, n), jra.zigzag_permute(k, n),
                jra.zigzag_permute(v, n), mesh, segment_ids=zs)
            return jra.zigzag_unpermute(o, n)
        fn = jra.ulysses_attention if scheme == "ulysses" else \
            jra.ring_attention
        return fn(q, k, v, mesh, causal=causal, segment_ids=seg)

    q, k, v = (jnp.asarray(x[n_]) for n_ in "qkv")
    out = {"o": np.asarray(f(q, k, v))}
    if grads:
        w = jnp.asarray(x["w"])
        g = jax.grad(lambda *a: jnp.sum(f(*a) * w), argnums=(0, 1, 2))(
            q, k, v)
        out.update({f"d{n_}": np.asarray(t) for n_, t in zip("qkv", g)})
    return out


def _cfg():
    return dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)


def _model_inputs(name, case):
    _, kind, s, _ = case
    rng = np.random.default_rng(11)
    b = 2
    out = {"tokens": rng.integers(1, 512, (b, s)).astype(np.int32)}
    if kind == "packed":
        out["segment_ids"] = _segments(b, s, seed=7)
        out["positions"] = np.broadcast_to(np.arange(s, dtype=np.int32),
                                           (b, s)).copy()
    return out


def _jax_model(case, params, x, meshes):
    mesh_name, kind, _, zigzag = case
    mesh = meshes[mesh_name]
    cfg = _cfg()
    rules = dict(jsh.ACT_RULES, seq_layout="zigzag") if zigzag else None
    if kind == "forward":
        return {"logits": np.asarray(jl.forward(
            params, jnp.asarray(x["tokens"]), cfg, mesh=mesh, rules=rules))}
    batch = {k: jnp.asarray(v) for k, v in x.items()}
    loss, m = jl.loss_fn(params, batch, cfg, mesh=mesh, rules=rules)
    local, _ = jl.loss_fn(params, batch, cfg)
    return {"loss": float(loss), "loss_local": float(local),
            "accuracy": float(m["accuracy"])}


def _warm_state(cfg, batch):
    """Three unsharded JAX steps from seed 0 (warm Adam moments)."""
    tc = jt.TrainConfig(**TC)
    step = jt.make_train_step(cfg, tc, None)
    state = jt.create_train_state(cfg, tc, None, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        state, _ = step(state, jb)
    return jax.tree.map(lambda a: np.array(a), state)


def _jax_steps(cfg, warm, mesh, batch):
    tc = jt.TrainConfig(**TC)
    state = jax.device_put(jax.tree.map(jnp.asarray, warm),
                           jt.state_shardings(cfg, mesh))
    step = jt.make_train_step(cfg, tc, mesh)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(STEPS):
        state, m = step(state, jb)
        out.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return out


def _adam(node):
    if hasattr(node, "mu"):
        return node
    for child in node if isinstance(node, (tuple, list)) else ():
        found = _adam(child)
        if found is not None:
            return found
    return None


_RANK_BODY = """
import dataclasses
from types import SimpleNamespace
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import ring_attention as ra
from skypilot_tpu_torch.parallel import sharding as sh
from skypilot_tpu_torch.train import trainer as tt

job = json.load(open(os.path.join(DIR, "job.json")))
src = unflatten(dict(np.load(os.path.join(DIR, "in.npz"))))
meshes = {name: mesh_lib.make_mesh(mesh_lib.MeshShape(**kw), "cpu")
          for name, kw in job["meshes"].items()}
out = {}


def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


for name, (mesh_name, scheme, causal, _, _, grads) in job.get(
        "attn", {}).items():
    mesh = meshes[mesh_name]
    n = mesh_lib.mesh_shape(mesh).sp
    x = {k: torch.from_numpy(v) for k, v in src["attn"][name].items()}
    seg = x.get("seg")
    # Whole inputs, replicated DTensor leaves: the gradients come back
    # whole on every rank.
    leaves = [sh.distribute(x[k], mesh, ()).detach().requires_grad_()
              for k in "qkv"]
    q, k, v = leaves
    if scheme == "zigzag":
        zs = None if seg is None else ra.zigzag_permute(seg, n)
        o = ra.zigzag_ring_attention(
            ra.zigzag_permute(q, n), ra.zigzag_permute(k, n),
            ra.zigzag_permute(v, n), mesh, segment_ids=zs)
        o = ra.zigzag_unpermute(o, n)
    else:
        fn = ra.ulysses_attention if scheme == "ulysses" else \\
            ra.ring_attention
        o = fn(q, k, v, mesh, causal=causal, segment_ids=seg)
    out[f"attn/{name}/o"] = whole(o).detach().numpy()
    if grads:
        loss = (whole(o) * x["w"]).sum()
        loss.backward()
        for nm, t in zip("qkv", leaves):
            out[f"attn/{name}/d{nm}"] = whole(t.grad).numpy()

cfg = dataclasses.replace(llama.CONFIGS["llama3-tiny"], dtype=torch.float32)
for name, (mesh_name, kind, _, zigzag) in job.get("model", {}).items():
    params = llama.params_from_numpy(src["params"], cfg, "cpu")
    mesh = meshes[mesh_name]
    rules = dict(sh.ACT_RULES, seq_layout="zigzag") if zigzag else \\
        sh.ACT_RULES
    c = sh.make_constrain(mesh, rules)
    p = sh.distribute_tree(params, sh.logical_to_sharding(
        llama.param_logical_axes(cfg), mesh, sh.DEFAULT_RULES,
        shapes=params))
    x = {k: torch.from_numpy(v) for k, v in src["model"][name].items()}
    with torch.no_grad():
        if kind == "forward":
            h = llama.forward_hidden(p, x["tokens"], cfg, constrain=c)
            out[f"model/{name}/logits"] = whole(
                llama.logits(h, p, cfg, c)).numpy()
        else:
            loss, m = llama.loss_fn(p, x, cfg, constrain=c)
            out[f"model/{name}/loss"] = np.asarray(float(whole(loss)))
            out[f"model/{name}/accuracy"] = np.asarray(
                float(whole(m["accuracy"])))

st = src.get("train")
if st is not None:
    mesh = meshes["dp2-sp2-tp2"]
    jax_like = {"params": st["params"], "step": st["step"],
                "opt_state": (SimpleNamespace(count=st["count"], mu=st["mu"],
                                              nu=st["nu"]),)}
    tc = tt.TrainConfig(**job["tc"])
    state = tt.train_state_from_numpy(jax_like, cfg, "cpu", mesh=mesh)
    step = tt.make_train_step(cfg, tc, mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in st["batch"].items()}
    for i in range(job["steps"]):
        _, m = step(state, batch)
        for key in ("loss", "grad_norm"):
            out[f"train/{key}{i}"] = m[key].numpy()
if RANK == 0:
    np.savez(os.path.join(DIR, "out.npz"), **out)
"""


def _spawn(tmp, job: dict, arrays: dict) -> dict:
    """Run the rank body on eight CPU ranks over ``job`` and ``arrays``;
    rank 0's outputs."""
    np.savez(os.path.join(tmp, "in.npz"), **torch_ranks.flatten(arrays))
    with open(os.path.join(tmp, "job.json"), "w") as f:
        json.dump(dict(job, meshes=MESHES), f)
    torch_ranks.run_ranks(8, _RANK_BODY, tmp,
                          timeout=torch_ranks.SLOW_TIMEOUT_S)
    return dict(np.load(os.path.join(tmp, "out.npz")))


@pytest.fixture(scope="module")
def attn_results(tmp_path_factory):
    """Every attention case on eight CPU ranks, and the JAX functions on
    the same meshes: (port, jax)."""
    jmeshes = {n: jmesh.make_mesh(jmesh.MeshShape(**kw)) for n, kw in
               MESHES.items()}
    attn_in = {n: _attn_inputs(n, c, seed=i)
               for i, (n, c) in enumerate(ATTN_CASES.items())}
    port = _spawn(tmp_path_factory.mktemp("ring8"), {"attn": ATTN_CASES},
                  {"attn": attn_in})
    return port, {n: _jax_attn(c, attn_in[n], jmeshes)
                  for n, c in ATTN_CASES.items()}


@pytest.fixture(scope="module")
def model_results(tmp_path_factory):
    """The model cases and the sharded steps on eight CPU ranks, and the
    JAX model on the same meshes: (port, jax)."""
    jmeshes = {n: jmesh.make_mesh(jmesh.MeshShape(**kw)) for n, kw in
               MESHES.items()}
    model_in = {n: _model_inputs(n, c) for n, c in MODEL_CASES.items()}
    cfg = _cfg()
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.key(0), cfg))
    train_batch = {"tokens": np.random.default_rng(5).integers(
        0, 512, (4, 64)).astype(np.int32)}
    warm = _warm_state(cfg, train_batch)
    adam = _adam(warm["opt_state"])
    port = _spawn(tmp_path_factory.mktemp("model8"),
                  {"model": MODEL_CASES, "tc": TC, "steps": STEPS},
                  {"model": model_in, "params": params,
                   "train": {"params": warm["params"], "mu": adam.mu,
                             "nu": adam.nu, "count": np.asarray(adam.count),
                             "step": np.asarray(warm["step"]),
                             "batch": train_batch}})
    want = {"model": {n: _jax_model(c, params, model_in[n], jmeshes)
                      for n, c in MODEL_CASES.items()},
            "train": _jax_steps(cfg, warm, jmeshes["dp2-sp2-tp2"],
                                train_batch)}
    return port, want


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_attention_matches_the_jax_function(attn_results, name):
    """Each scheme's output (and, for the gradient cases, dQ, dK and dV
    of sum(O * w)) against the JAX function on the same mesh."""
    port, want = attn_results
    ref = want[name]
    np.testing.assert_allclose(port[f"attn/{name}/o"], ref["o"], rtol=ATOL,
                               atol=ATOL)
    for g in ("dq", "dk", "dv"):
        if g in ref:
            np.testing.assert_allclose(port[f"attn/{name}/{g}"], ref[g],
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=g)


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_over_sp_matches_the_jax_model(model_results, name):
    """llama3-tiny in float32 over ``dp2-sp2-tp2``: the forward's logits
    (ring attention; the zigzag rule on a sequence 2n does not divide
    and an odd sequence fall back to contiguous or local attention), the
    packed loss and the zigzag loss, against the JAX model on the same
    mesh; the packed losses also equal the unsharded JAX loss."""
    port, want = model_results
    ref = want["model"][name]
    if "logits" in ref:
        got = port[f"model/{name}/logits"]
        assert got.shape == ref["logits"].shape
        np.testing.assert_allclose(got, ref["logits"], rtol=1e-4, atol=1e-4)
        return
    loss = float(port[f"model/{name}/loss"])
    np.testing.assert_allclose(loss, ref["loss"], rtol=2e-4)
    np.testing.assert_allclose(loss, ref["loss_local"], rtol=2e-4)
    np.testing.assert_allclose(float(port[f"model/{name}/accuracy"]),
                               ref["accuracy"], rtol=1e-5, atol=1e-6)


def test_sharded_train_step_at_sp2_matches_jax(model_results):
    """Two float32 steps of llama3-tiny (batch 4 x 64, the reference
    test's) over ``dp2-sp2-tp2`` (ring attention in the step) from one
    warm JAX
    state: loss and grad norm within 1e-5 relative of the JAX step's."""
    port, want = model_results
    for i, m in enumerate(want["train"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(port[f"train/{k}{i}"]), m[k],
                                       rtol=1e-5, err_msg=f"{k} step {i}")


# -- in one process ----------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_zigzag_round_trip_matches_the_reference(n):
    x = np.arange(2 * 32 * 3).reshape(2, 32, 3)
    got = tra.zigzag_permute(torch.from_numpy(x), n)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jra.zigzag_permute(x, n)))
    np.testing.assert_array_equal(tra.zigzag_unpermute(got, n).numpy(), x)
    perm, inv = tra.zigzag_indices(32, n)
    want_perm, want_inv = jra.zigzag_indices(32, n)
    np.testing.assert_array_equal(perm, want_perm)
    np.testing.assert_array_equal(inv, want_inv)
    with pytest.raises(ValueError, match="not divisible"):
        tra.zigzag_indices(30, n)


def test_batch_and_head_specs_match_the_reference():
    """The batch-prefix fallback and the all-or-nothing head split."""
    meshes = {n: jmesh.make_mesh(jmesh.MeshShape(**kw))
              for n, kw in MESHES.items()}
    for name, jm in meshes.items():
        shape = dict(MESHES[name])
        for b in (1, 2, 3, 4):
            assert tra._batch_spec(("dp", "fsdp"), shape, b) == \
                jra._batch_spec(("dp", "fsdp"), jm, b)
        for hq, hkv in ((4, 4), (8, 2), (3, 3), (4, 2)):
            q = np.zeros((2, 32, hq, 8))
            k = np.zeros((2, 32, hkv, 8))
            got = tra._qkv_specs(shape, "sp", ("dp", "fsdp"), "tp", q, k)
            ref = jra._qkv_specs(jm, "sp", ("dp", "fsdp"), "tp", q, k)
            assert got == tuple(tuple(s) for s in ref), (name, hq, hkv)


@pytest.mark.parametrize("scheme", ["ring", "ring-full", "zigzag",
                                    "ulysses", "ulysses-full"])
@pytest.mark.parametrize("seg", [False, True])
def test_step_bodies_block_by_block(scheme, seg):
    """The distributed ring loop over 4 ranks held side by side in one
    process (``loopback``: the ring's shift a hand-over of the next
    block, Ulysses's all-to-all a reshuffle), as the card's loopback runs
    it: O and dQ/dK/dV against autograd of plain attention over the
    whole sequence, GQA 2:1, float64 inputs (the ring bodies' products
    are float32)."""
    n, B, S, H, KV, D = 4, 2, 32, 4, 2, 8
    if scheme.startswith("ulysses"):
        H, KV = 8, 4                   # Ulysses splits the heads over n
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen,
                               dtype=torch.float64) for h in (H, KV, KV, H))
    ids = torch.from_numpy(_segments(B, S)) if seg else None
    causal = not scheme.endswith("-full")
    got = tra.loopback(scheme.split("-")[0], q, k, v, do, ids, n,
                       causal=causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = tattn.xla_attention(
        leaves[0], tattn.repeat_kv(leaves[1], H // KV),
        tattn.repeat_kv(leaves[2], H // KV), causal=causal,
        segment_ids=ids)
    want.backward(do)
    for g, w, name in zip(got, [want] + [t.grad for t in leaves],
                          ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_context_parallel_refuses_what_the_reference_refuses():
    shape = {"sp": 4}
    q = torch.zeros(1, 30, 4, 8)
    k = torch.zeros(1, 30, 2, 8)
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        tra.ring_attention(q, k, k, shape)
    with pytest.raises(ValueError, match="zigzag needs seq divisible"):
        tra.zigzag_ring_attention(torch.zeros(1, 36, 4, 8),
                                  torch.zeros(1, 36, 2, 8),
                                  torch.zeros(1, 36, 2, 8), shape)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        tra.ring_attention(torch.zeros(1, 32, 4, 8),
                           torch.zeros(1, 32, 3, 8),
                           torch.zeros(1, 32, 3, 8), shape)
    with pytest.raises(ValueError, match="use ring_attention instead"):
        tra.ulysses_attention(torch.zeros(1, 32, 2, 8),
                              torch.zeros(1, 32, 2, 8),
                              torch.zeros(1, 32, 2, 8), {"sp": 4, "tp": 1})
