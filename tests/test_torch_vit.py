"""The port's ViT classifier against the JAX package's on the CPU, at
vit-tiny in float32: patchify, the parameter count, the forward, loss
and gradients, five trainer steps through the trainer's ``model=``, and
the trainer's bookkeeping on an image batch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import vit as jv
from skypilot_tpu.train import trainer as jt
from skypilot_tpu_torch.models import vit as tv
from skypilot_tpu_torch.train import trainer as tt

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)


def _cfgs():
    return (dataclasses.replace(jv.CONFIGS["vit-tiny"], dtype=jnp.float32),
            dataclasses.replace(tv.CONFIGS["vit-tiny"], dtype=torch.float32))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def jax_params():
    return _np_tree(jv.init_params(jax.random.key(0), _cfgs()[0]))


def _batch(cfg, n=4, seed=0):
    """Images and labels from a numpy seed, as numpy arrays."""
    b = tv.synthetic_batch(cfg, n, seed=seed, device="cpu")
    return {k: v.numpy() for k, v in b.items()}


def test_patchify_roundtrip_matches_jax():
    jcfg, tcfg = _cfgs()
    imgs = np.arange(2 * 32 * 32 * 3, dtype=np.float32).reshape(2, 32, 32, 3)
    got = tv.patchify(torch.from_numpy(imgs), tcfg)
    assert got.shape == (2, tcfg.n_patches, tcfg.patch_size ** 2 * 3)
    # The first patch is the top-left 8x8 block, row-major.
    np.testing.assert_array_equal(got[0, 0].numpy().reshape(8, 8, 3),
                                  imgs[0, :8, :8, :])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jv.patchify(jnp.asarray(imgs), jcfg)))


def test_param_count_and_layout_match(jax_params):
    _, tcfg = _cfgs()
    for name in tv.CONFIGS:
        assert tv.CONFIGS[name].num_params() == jv.CONFIGS[name].num_params()
        assert tv.CONFIGS[name].head_dim == jv.CONFIGS[name].head_dim
    p = tv.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(x.numel() for x in tt._layer_leaves(p)) == \
        tcfg.num_params() == sum(x.size for x in
                                 jax.tree.leaves(jax_params))
    assert jax.tree.structure(jax_params) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, p))
    for a, b in zip(jax.tree.leaves(jax_params), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), p))):
        assert a.shape == b.shape


def test_synthetic_batch_is_seeded():
    _, tcfg = _cfgs()
    a = tv.synthetic_batch(tcfg, 3, seed=4, device="cpu")
    b = tv.synthetic_batch(tcfg, 3, seed=4, device="cpu")
    assert a["images"].shape == (3, 32, 32, 3)
    assert a["images"].dtype == torch.float32
    assert a["labels"].dtype == torch.int32
    assert int(a["labels"].max()) < tcfg.num_classes
    assert torch.equal(a["images"], b["images"])


def test_forward_loss_and_grads_match_jax(jax_params):
    """float32 on both sides: logits within 1e-5 of their largest
    magnitude, the loss within 1e-5 relative, every gradient within 1e-5
    of its largest magnitude."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(jnp.asarray, jax_params)
    tp = tv.params_from_numpy(jax_params, tcfg, device="cpu")
    batch = _batch(tcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlog = np.asarray(jv.forward(jp, jbatch["images"], jcfg))
    with torch.no_grad():
        tlog = tv.forward(tp, tbatch["images"], tcfg)
    np.testing.assert_allclose(tlog.numpy(), jlog,
                               atol=1e-5 * np.abs(jlog).max())
    (jloss, jmet), jg = jax.value_and_grad(
        lambda p: jv.loss_fn(p, jbatch, jcfg), has_aux=True)(jp)
    loss, met, grads = tt.grads_of(tp, tbatch, tcfg, model=tv)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert met["accuracy"].item() == float(jmet["accuracy"])
    assert met["tokens"].item() == float(jmet["tokens"]) == 4.0
    want = tt._layer_leaves(_np_tree(jg), tp)
    assert len(want) == len(grads)
    for w, g in zip(want, grads):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max())


def test_five_steps_match_jax_trainer():
    """Three JAX steps reach a mid-warmup state; both trainers take five
    more on one batch: loss and grad_norm within 1e-4 relative per step,
    the parameters after them within 2e-6 + 1e-4 relative (the llama
    trainer test's bounds); the loss falls, as in the reference's
    ``test_memorizes_fixed_batch``."""
    jcfg, tcfg = _cfgs()
    kw = dict(learning_rate=3e-3, warmup_steps=6, total_steps=20)
    jtc, ttc = jt.TrainConfig(**kw), tt.TrainConfig(**kw)
    batch = _batch(tcfg, n=8, seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jt.make_train_step(jcfg, jtc, None, model=jv)
    jstate = jt.create_train_state(jcfg, jtc, None, seed=0, model=jv)
    for _ in range(3):
        jstate, _ = jstep(jstate, jbatch)
    state = tt.train_state_from_numpy(_np_tree(jstate), tcfg, device="cpu",
                                      model=tv)
    tstep = tt.make_train_step(tcfg, ttc, model=tv)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for i in range(5):
        jstate, jmet = jstep(jstate, jbatch)
        state, met = tstep(state, tbatch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                       rtol=1e-4, err_msg=f"{key} {i}")
        losses.append(met["loss"].item())
    assert losses[-1] < losses[0]
    assert state["step"] == int(jstate["step"]) == 8
    want = _np_tree(jstate)
    for w, p in zip(tt._layer_leaves(want["params"], state["params"]),
                    tt._layer_leaves(state["params"])):
        np.testing.assert_allclose(p.numpy(), w, atol=2e-6, rtol=1e-4)


def test_trainer_bookkeeping_takes_an_image_batch():
    """The step's instrumentation and compile watch read an image batch:
    it counts no tokens (as the reference's does) and its program key
    is its shapes."""
    _, tcfg = _cfgs()
    b = tv.synthetic_batch(tcfg, 2, device="cpu")
    assert tt.batch_tokens(b) == 0
    assert tt._batch_key_fn((None, b), {}) == [("images", "2x32x32x3"),
                                               ("labels", "2")]
    state = tt.create_train_state(tcfg, tt.TrainConfig(), "cpu", model=tv)
    assert "wqkv" in state["params"]["blocks"]
    step = tt.make_train_step(tcfg, tt.TrainConfig(), model=tv)
    state, met = step(state, b)
    assert state["step"] == 1 and np.isfinite(met["loss"].item())
