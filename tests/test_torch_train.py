"""The port's training path against the JAX package's, on the CPU at
llama3-tiny in float32: the loss and its gradients, the learning-rate
schedule, five optimizer steps from a shared mid-warmup state, and the
packing pipeline."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.data import input_pipeline as jip
from skypilot_tpu.models import llama as jl
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.data import input_pipeline as tip
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.train import trainer as tt

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32,
                               **kw)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


def _packed_batch(batch=2, seq=64, seed=0):
    docs = list(jip.synthetic_doc_stream(40, 512, mean_len=20, seed=seed))
    return next(tip.packed_batches(docs, batch, seq))


def _batch(kind):
    rng = np.random.default_rng(5)
    if kind == "packed":
        return _packed_batch()
    b = {"tokens": rng.integers(0, 512, (2, 33)).astype(np.int32)}
    if kind == "masked":
        b["mask"] = (rng.random((2, 33)) < 0.7).astype(np.float32)
    return b


def _np_tree(tree):
    # np.array copies: a donated JAX buffer must not alias these.
    return jax.tree.map(lambda x: np.array(x), tree)


# (batch kind, xent_chunk): unchunked, chunked without and with padding
# (32 targets into chunks of 8 and of 12), and packed documents
# (positions, segment ids and the packed loss mask), chunked.
LOSS_CASES = [("plain", 0), ("plain", 8), ("masked", 12), ("packed", 0),
              ("packed", 16)]


@pytest.mark.parametrize("kind,chunk", LOSS_CASES,
                         ids=[f"{k}-chunk{c}" for k, c in LOSS_CASES])
def test_loss_and_grads_match_jax(kind, chunk):
    """fp32 on both sides; they differ in summation order only, so the
    loss is held to 1e-5 relative and each gradient to 1e-5 of its
    largest magnitude."""
    jcfg, tcfg = _cfgs(xent_chunk=chunk)
    jp = jl.init_params(jax.random.key(0), jcfg)
    batch = _batch(kind)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jl.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jcfg), has_aux=True)(jp)
    tp = tl.params_from_numpy(_np_tree(jp), tcfg, device="cpu")
    loss, metrics, grads = tt.grads_of(tp, tip.to_device(batch, "cpu"), tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["accuracy"].item(),
                               float(jm["accuracy"]), atol=1e-6)
    assert metrics["tokens"].item() == float(jm["tokens"])
    want = tt._layer_leaves(_np_tree(jg), tp)
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


def test_packed_loss_mask_matches_jax():
    batch = _packed_batch(batch=3, seq=48, seed=2)
    want = np.asarray(jl.packed_loss_mask(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    got = tl.packed_loss_mask(tip.to_device(batch, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tl.packed_loss_mask({"tokens": None}) is None


def test_remat_matches_no_remat():
    _, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    params = tl.init_params(tcfg, gen, device="cpu")
    batch = tip.to_device(_batch("plain"), "cpu")
    a = tt.grads_of(params, batch, tcfg)
    b = tt.grads_of(params, batch,
                    dataclasses.replace(tcfg, remat=False))
    assert a[0].item() == b[0].item()
    for x, y in zip(a[2], b[2]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        tt.grads_of(params, batch,
                    dataclasses.replace(tcfg, remat_policy="dots"))


@pytest.mark.parametrize("warmup,total", [(5, 20), (1, 4), (100, 50)])
def test_lr_schedule_matches_optax(warmup, total):
    tc = jt.TrainConfig(learning_rate=3e-4, warmup_steps=warmup,
                        total_steps=total)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=tc.learning_rate,
        warmup_steps=tc.warmup_steps,
        decay_steps=max(tc.total_steps, tc.warmup_steps + 1, 1),
        end_value=tc.learning_rate * 0.1)
    got = tt.lr_schedule(tt.TrainConfig(**dataclasses.asdict(tc)))
    assert got(0) == 0.0
    for step in range(max(total, warmup) + 5):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


# grad_clip 0.5 sits below every step's gradient norm here (the clip
# branch fires), 1e3 above it (gradients pass unclipped).
STEP_CASES = [(None, 0.5), (None, 1e3), ("bfloat16", 0.5)]


@pytest.mark.parametrize("mu_dtype,clip", STEP_CASES,
                         ids=[f"mu-{m}-clip{c}" for m, c in STEP_CASES])
def test_five_steps_match_jax_trainer(mu_dtype, clip):
    """Three JAX steps reach a mid-warmup state (count 3 of a 6-step
    warmup); both trainers then take five steps on it. Per step, loss
    and grad_norm agree within 1e-4 relative; the parameters after the
    five steps within 2e-6 + 1e-4 relative: Adam normalises each
    gradient, so last-digit gradient differences show up as ~1e-6 of
    the lr-sized (1e-2) updates. With a bf16 first moment a last-digit
    difference can flip mu's bf16 rounding, one ulp (2^-8 relative),
    which moves an update by up to ~4e-5 per step: 3e-4 over five."""
    jcfg, tcfg = _cfgs()
    tc_kw = dict(learning_rate=1e-2, warmup_steps=6, total_steps=20,
                 grad_clip=clip, mu_dtype=mu_dtype)
    jtc, ttc = jt.TrainConfig(**tc_kw), tt.TrainConfig(**tc_kw)
    batch = _batch("plain")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jt.make_train_step(jcfg, jtc, None)
    jstate = jt.create_train_state(jcfg, jtc, None, seed=0)
    for _ in range(3):
        jstate, _ = jstep(jstate, jbatch)
    state = tt.train_state_from_numpy(_np_tree(jstate), tcfg, device="cpu")
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    tstep = tt.make_train_step(tcfg, ttc)
    tbatch = tip.to_device(batch, "cpu")
    fired = []
    for i in range(5):
        jstate, jm = jstep(jstate, jbatch)
        state, m = tstep(state, tbatch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} {i}")
        fired.append(float(jm["grad_norm"]) >= clip)
    assert all(fired) if clip < 1 else not any(fired)
    assert state["step"] == int(jstate["step"]) == 8
    atol = 3e-4 if mu_dtype else 2e-6
    want = _np_tree(jstate)
    for w, p in zip(tt._layer_leaves(want["params"], state["params"]),
                    tt._layer_leaves(state["params"])):
        np.testing.assert_allclose(p.numpy(), w, atol=atol, rtol=1e-4)
    mu = tt._layer_leaves(state["opt_state"]["mu"])
    assert all(t.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
               for t in mu)


def test_train_state_from_numpy_rejects_a_state_without_adam():
    with pytest.raises(ValueError):
        tt.train_state_from_numpy({"params": {}, "opt_state": (), "step": 0},
                                  tl.CONFIGS["llama3-tiny"], device="cpu")


def test_create_train_state_layout():
    _, tcfg = _cfgs()
    tc = tt.TrainConfig(mu_dtype="bfloat16")
    state = tt.create_train_state(tcfg, tc, device="cpu", seed=1)
    assert state["step"] == 0 and state["opt_state"]["count"] == 0
    p = state["params"]
    assert p["blocks"]["wq"].shape == (2, 128, 4, 32)
    assert state["opt_state"]["mu"]["embed"].dtype == torch.bfloat16
    assert state["opt_state"]["nu"]["embed"].dtype == torch.float32
    b = tt.synthetic_batch(tcfg, 3, 16, seed=2, device="cpu")
    assert b["tokens"].shape == (3, 16) and b["tokens"].dtype == torch.int32
    assert int(b["tokens"].max()) < tcfg.vocab_size


# -- the input pipeline -------------------------------------------------------

def test_pack_and_packed_batches_match_jax():
    docs = list(jip.synthetic_doc_stream(60, 512, mean_len=24, seed=3))
    for a, b in zip(tip.pack(docs, 4, 64),
                    jip.pack(docs, 4, 64, force_numpy=True)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = list(tip.packed_batches(iter(docs), 2, 96))
    want = list(jip.packed_batches(iter(docs), 2, 96, force_numpy=True))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert list(tip.synthetic_doc_stream(5, 99, 7, seed=4)) == \
        list(jip.synthetic_doc_stream(5, 99, 7, seed=4))


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"]


def test_prefetch_moves_batches_and_its_thread_ends():
    def forever():
        i = 0
        while True:
            yield {"tokens": np.full((2, 4), i, np.int32)}
            i += 1

    it = tip.prefetch(forever(), device="cpu")
    first = [next(it)["tokens"] for _ in range(3)]
    assert all(isinstance(t, torch.Tensor) for t in first)
    assert [int(t[0, 0]) for t in first] == [0, 1, 2]
    assert _prefetch_threads()
    it.close()                        # the consumer stops
    assert not _prefetch_threads()

    finite = tip.prefetch(({"x": np.zeros(2)} for _ in range(3)),
                          device="cpu")
    assert len(list(finite)) == 3
    assert not _prefetch_threads()


def test_prefetch_reraises_the_producer_error():
    def broken():
        yield {"x": np.zeros(1)}
        raise RuntimeError("bad batch")

    it = tip.prefetch(broken(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="bad batch"):
        next(it)
    assert not _prefetch_threads()
