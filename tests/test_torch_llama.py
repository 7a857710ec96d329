"""The port's llama model against the JAX package's, on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.models import llama as tl

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    np_tree = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, np_tree


@pytest.mark.parametrize("name", sorted(jl.CONFIGS))
def test_configs_equal(name):
    j, t = jl.CONFIGS[name], tl.CONFIGS[name]
    for f in dataclasses.fields(jl.LlamaConfig):
        jv, tv = getattr(j, f.name), getattr(t, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert _DTYPES[jv] == tv, f.name
        else:
            assert jv == tv, f.name
    assert j.head_dim == t.head_dim
    assert j.num_params() == t.num_params()
    assert sorted(tl.CONFIGS) == sorted(jl.CONFIGS)


def test_params_from_numpy_round_trip(tiny):
    _, tcfg, _, np_tree = tiny
    tp = tl.params_from_numpy(np_tree, tcfg, device="cpu")
    back = jax.tree.map(lambda x: x.numpy(), tp)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        assert a.shape == b.shape and np.array_equal(a, b)
    # bf16 leaves widen exactly into any target dtype.
    bf = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                      np_tree)
    tb = tl.params_from_numpy(bf, tcfg, device="cpu",
                              dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        tb["embed"].float().numpy(), np.asarray(bf["embed"], np.float32))


def test_init_params_shapes_match(tiny):
    jcfg, tcfg, jp, _ = tiny
    gen = torch.Generator().manual_seed(0)
    tp = tl.init_params(tcfg, gen, device="cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    assert jax.tree.map(lambda x: tuple(x.shape), tp) == shapes
    assert tp["embed"].dtype == torch.float32


def test_rms_norm_and_rope_match(tiny):
    jcfg, tcfg, _, _ = tiny
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, tcfg.head_dim)).astype(np.float32)
    scale = rng.standard_normal((tcfg.head_dim,)).astype(np.float32)
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for pos in (np.arange(7), np.arange(14).reshape(2, 7) * 3):
        jc, js = jl.rope_frequencies(jcfg, jnp.asarray(pos))
        tc, ts = tl.rope_frequencies(tcfg, torch.from_numpy(pos))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
        got = tl.apply_rope(torch.from_numpy(x), tc, ts)
        want = jl.apply_rope(jnp.asarray(x), jc, js)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5)


def test_forward_logits_match(tiny):
    jcfg, tcfg, jp, np_tree = tiny
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 24))
    want = np.asarray(jl.forward(jp, jnp.asarray(tokens), jcfg))
    tp = tl.params_from_numpy(np_tree, tcfg, device="cpu")
    got = tl.forward(tp, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    module = tl.Llama(tcfg, tp)
    np.testing.assert_array_equal(
        module(torch.from_numpy(tokens)).numpy(), got.numpy())
