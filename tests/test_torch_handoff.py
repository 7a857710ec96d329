"""The port's cross-replica KV handoff against the JAX package's on the
CPU, in float32 at llama3-tiny with chunks and blocks of 8 (the
reference's own setting, ``tests/test_disagg.py``): block export and
import bit-equal to the JAX functions, the wire form byte-equal to the
reference's, the eligibility rule, the resume context (a request
admitted with committed tokens finishes with the JAX engine's tokens),
handoffs port to port, JAX to port and port to JAX, the cold resumes
and the "already warm" answer, leak audits on both tiers, and the
reference load balancer driving a two-tier service of port replicas
(and a mixed one: a JAX prefill replica before a port decode
replica)."""

import dataclasses
import json
import os
import socket
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import chaos
from skypilot_tpu.infer import engine as je
from skypilot_tpu.infer import kvcache as jkv
from skypilot_tpu.infer import server as js
from skypilot_tpu.models import llama as jl
from skypilot_tpu.serve import load_balancer, serve_state
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.infer import server as ts
from skypilot_tpu_torch.models import llama as tl

CHUNK = 8
SYSTEM = list(range(5, 21))                 # 16 tokens = 2 chunks
PROMPT = SYSTEM + [31, 32, 33]              # 19 tokens: 16 cached


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


def _kw(**more):
    kw = dict(n_slots=4, max_len=64, prompt_buckets=(48,),
              prefill_chunk=CHUNK, prefix_pool=8, kv_block=CHUNK, spec_k=0)
    kw.update(more)
    return kw


def _jax(models, **more):
    jcfg, _, jp, _ = models
    # The Pallas paged kernel in interpret mode: the program the port's
    # kernel path is held to.
    return je.InferenceEngine(jp, jcfg, kv_kernel=True, **_kw(**more))


def _port(models, plain=False, **more):
    _, tcfg, _, tp = models
    return te.InferenceEngine(tp, tcfg, device="cpu",
                              plain_attention=plain, **_kw(**more))


def _used(e):
    return e.blocks_used() if callable(e.blocks_used) else e.blocks_used


def _resident(e):
    return sum(len(p) for p in e._prefix_index.payloads())


@pytest.fixture(scope="module")
def single(models):
    """The JAX engine's single-tier tokens for PROMPT (6 new), by
    spec K."""
    return {k: _jax(models, spec_k=k).generate([PROMPT], 6)[0]
            for k in (0, 3)}


# -- export_blocks / import_blocks --------------------------------------------

@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_export_import_blocks_bit_equal_jax(kind):
    """The gather and the scatter of the port (``nb`` real ids, pools
    with the trash block) give the JAX functions' bits (a sentinel-padded
    id vector over pools without it) on the same numpy pools, scales
    included; the port's trash block is untouched by the import."""
    rng = np.random.default_rng(0)
    L, NB, BL, G, hd, nb_slot = 2, 6, 8, 2, 16, 4
    shape = (L, NB + 1, BL, G, hd)
    if kind == "int8":
        pools = {n: rng.integers(-127, 128, shape, dtype=np.int8)
                 for n in ("k", "v")}
        pools.update({n: rng.standard_normal((L, NB + 1, G, BL)).astype(
            np.float32) for n in ("k_scale", "v_scale")})
        jdt = {"k": jnp.int8, "v": jnp.int8, "k_scale": jnp.bfloat16,
               "v_scale": jnp.bfloat16}
    else:
        pools = {n: rng.standard_normal(shape).astype(np.float32)
                 for n in ("k", "v")}
        jdt = dict.fromkeys(("k", "v"), jnp.float32 if kind == "fp32"
                            else jnp.bfloat16)
    jcache = {n: jnp.asarray(a[:, :NB]).astype(jdt[n])
              for n, a in pools.items()}
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
           jnp.int8: torch.int8}
    tcache = {n: torch.from_numpy(a.copy()).to(tdt[jdt[n]])
              for n, a in pools.items()}

    def host(t):
        t = t.float() if t.is_floating_point() else t
        return t.numpy()

    def jhost(a):
        return np.asarray(a.astype(jnp.float32) if a.dtype != jnp.int8
                          else a)

    ids = [3, 0, 5]
    jids = np.full((nb_slot,), NB, np.int32)
    jids[:len(ids)] = ids
    jout = jkv.export_blocks(jcache, jnp.asarray(jids))
    tout = tkv.export_blocks(tcache, torch.tensor(ids))
    assert set(jout) == set(tout) == set(pools)
    for n in pools:
        np.testing.assert_array_equal(host(tout[n]),
                                      jhost(jout[n])[:, :len(ids)])
    # Import the exported rows (float32 on the wire for float planes)
    # into other blocks.
    dst = [1, 4, 2]
    jdst = np.full((nb_slot,), NB, np.int32)
    jdst[:len(dst)] = dst
    wire = {n: jhost(v) for n, v in jout.items()}
    jcache = jkv.import_blocks(jcache, jnp.asarray(jdst),
                               {n: jnp.asarray(a) for n, a in wire.items()})
    trash = {n: t[:, NB].clone() for n, t in tcache.items()}
    tkv.import_blocks(tcache, torch.tensor(dst),
                      {n: torch.from_numpy(np.array(a[:, :len(dst)]))
                       for n, a in wire.items()})
    for n in pools:
        assert tcache[n].dtype == tdt[jdt[n]]
        np.testing.assert_array_equal(host(tcache[n][:, :NB]),
                                      jhost(jcache[n]))
        assert torch.equal(tcache[n][:, NB], trash[n])


# -- the wire -------------------------------------------------------------------

def _export(kind, rng):
    L, nb, BL, G, hd = 2, 3, 8, 2, 16
    shape = (L, nb, BL, G, hd)
    if kind == "int8":
        tensors = {n: rng.integers(-127, 128, shape, dtype=np.int8)
                   for n in ("k", "v")}
        tensors.update({n: rng.standard_normal((L, nb, G, BL)).astype(
            np.float32) for n in ("k_scale", "v_scale")})
    else:
        tensors = {n: rng.standard_normal(shape).astype(np.float32)
                   for n in ("k", "v")}
    return {"cached_len": 24, "kv_block": BL, "n_blocks": nb,
            "salt": b"\x01adapter\xff" if kind == "salt" else b"",
            "tensors": tensors}


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "salt"])
def test_encode_export_is_the_reference_wire(kind):
    """``encode_export`` gives the reference's JSON byte for byte: for a
    bf16 pool the reference encodes bfloat16 arrays and widens them,
    the port's export is already widened on the device; ``decode_export``
    inverts it (and the reference's decoder reads the port's wire)."""
    rng = np.random.default_rng(1)
    port = _export(kind, rng)
    ref = port
    if kind == "bf16":
        # The port widens a bf16 pool's planes as export_prefix_for
        # does; the reference encodes the bf16 planes themselves.
        ref = dict(port, tensors={n: np.asarray(jnp.asarray(a, jnp.bfloat16))
                                  for n, a in port["tensors"].items()})
        port = dict(port, tensors={
            n: torch.from_numpy(a).bfloat16().float().numpy()
            for n, a in port["tensors"].items()})
        assert str(ref["tensors"]["k"].dtype) == "bfloat16"
    wire = json.dumps(ts.encode_export(port))
    assert wire == json.dumps(js.encode_export(ref))
    for dec in (ts.decode_export, js.decode_export):
        back = dec(json.loads(wire))
        assert {k: back[k] for k in ("cached_len", "kv_block", "n_blocks",
                                     "salt")} == \
            {k: port[k] for k in ("cached_len", "kv_block", "n_blocks",
                                  "salt")}
        for n, a in port["tensors"].items():
            assert back["tensors"][n].dtype == a.dtype
            np.testing.assert_array_equal(back["tensors"][n], a)


# -- eligibility -----------------------------------------------------------------

def test_handoff_eligible_matches_jax(models):
    """The same answer as the JAX engine's over prompt lengths around
    one chunk and max_len and budgets 0-3, with the prefix cache on and
    off."""
    for pool in (8, 0):
        j, t = _jax(models, prefix_pool=pool), _port(models, prefix_pool=pool)
        for n in (1, 7, 8, 9, 16, 17, 40, 62, 63, 64):
            for budget in (0, 1, 2, 3):
                prompt = list(range(1, n + 1))
                assert t.handoff_eligible(prompt, budget) == \
                    j.handoff_eligible(prompt, budget), (pool, n, budget)
    assert t.handoff_eligible(PROMPT, 2) is False             # pool 0
    assert _port(models).handoff_eligible(PROMPT, 2) is True


# -- the resume context ------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_committed_resume_finishes_with_jax_tokens(models, single, plain,
                                                   spec_k):
    """A request admitted with the first 1, 2 and 3 single-tier tokens
    committed (no prefix to reuse: a cold resume of prompt + committed
    through the chunk path) finishes with the JAX engine's single-tier
    tokens, as does the JAX engine's own resume; its budget counts the
    committed tokens, and its drafter sees them."""
    want = single[spec_k]
    j = _jax(models, spec_k=spec_k)
    e = _port(models, plain, spec_k=spec_k)
    for n in (1, 2, 3):
        for eng in (j, e):
            eng.clear_prefix_cache()
            eng.finished.clear()
            eng.add_request(PROMPT, 6, committed=want[:n])
            eng.run_to_completion()
            (req,) = eng.finished
            assert req.tokens == want, (type(eng).__module__, n)
            assert req.resumed_len == 0 and req.cached_len == 0
        assert e.finished[0].n_chunks == j.finished[0].n_chunks
        assert _used(e) == _resident(e)


# -- handoffs -----------------------------------------------------------------------

def _prefill(eng):
    eng.finished.clear()
    eng.add_request(PROMPT, 1)
    eng.run_to_completion()
    (req,) = eng.finished
    return req.tokens, eng.export_prefix_for(req)


def _decode(eng, committed, export, salt=b""):
    eng.finished.clear()
    got = eng.import_prefix(PROMPT + committed, export, salt=salt)
    eng.add_request(PROMPT, 6, committed=committed)
    eng.run_to_completion()
    (req,) = eng.finished
    return got, req


@pytest.mark.parametrize("src,dst", [("port", "port"), ("jax", "port"),
                                     ("port", "jax")])
def test_handoff_gives_the_single_tier_tokens(models, single, src, dst):
    """Prefill on one engine, export, the reference's wire (encoded by
    the source's server module, decoded by the destination's), import,
    resume: the JAX single-tier tokens, a resume over the 16 imported
    rows (``resumed_len`` = ``cached_len``), one prefix hit on the
    decode tier, and both tiers holding only their resident entries'
    blocks."""
    make = {"port": _port, "jax": _jax}
    enc = {"port": ts.encode_export, "jax": js.encode_export}
    dec = {"port": ts.decode_export, "jax": js.decode_export}
    p, d = make[src](models), make[dst](models)
    committed, export = _prefill(p)
    assert committed == single[0][:1] and export["cached_len"] == 16
    wire = dec[dst](json.loads(json.dumps(enc[src](export))))
    hits = d.prefix_hits if dst == "port" else d._prefix_hit_n
    got, req = _decode(d, committed, wire, wire["salt"])
    assert got == req.resumed_len == export["cached_len"] == 16
    assert req.tokens == single[0]
    assert (d.prefix_hits if dst == "port" else d._prefix_hit_n) == hits + 1
    for e in (p, d):
        assert _used(e) == _resident(e) > 0


@pytest.mark.parametrize("case", ["kv_block", "int8_into_float", "dry_pool"])
def test_cold_resume(models, single, case):
    """An export the decode tier cannot take resumes cold (import
    returns 0, no blocks held for it) with the single-tier tokens: a
    block length of 16 against 8, an int8 export into float pools, and
    a pool that stays dry while a long request holds it."""
    p = _port(models, kv_int8=(case == "int8_into_float"))
    committed, export = _prefill(p)
    committed = single[0][:1]      # the float engine's first token
    if case == "kv_block":
        d = _port(models, kv_block=16)
    elif case == "int8_into_float":
        d = _port(models)
    else:
        d = _port(models, kv_blocks=9)
        d.add_request([1, 2, 3, 4], 60)        # 8 of the 9 blocks
        d.admit()
        assert d.allocator.available == 1
    used = _used(d)
    assert d.import_prefix(PROMPT + committed, export) == 0
    assert _used(d) == used
    d.add_request(PROMPT, 6, committed=committed)
    d.run_to_completion()
    req = next(r for r in d.finished if r.prompt == PROMPT)
    assert req.resumed_len == 0 and req.tokens == single[0]
    assert _used(d) == _resident(d)


def test_import_into_an_already_warm_engine(models, single):
    """A decode tier that already holds the prefix returns the rows it
    covers, allocates nothing, and resumes over its own entry."""
    p, d = _port(models), _port(models)
    committed, export = _prefill(p)
    assert d.generate([PROMPT], 6)[0] == single[0]
    used = _used(d)
    assert d.import_prefix(PROMPT + committed, export) == 16
    assert _used(d) == used == _resident(d)
    got, req = _decode(d, committed, export)
    assert got == req.resumed_len == 16 and req.tokens == single[0]


# -- the reference load balancer before port replicas --------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stream(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    toks, done = [], None
    with urllib.request.urlopen(req, timeout=120) as r:
        for line in r:
            if not line.strip():
                continue
            obj = json.loads(line)
            assert "error" not in obj
            if "done" in obj:
                done = obj
                break
            toks.extend(obj.get("tokens") or [])
    return toks, done


@pytest.fixture(scope="module")
def fleet_env(tmp_path_factory):
    keys = ("SKYPILOT_TPU_HOME", "SKYTPU_PREFILL_CHUNK")
    old = {k: os.environ.get(k) for k in keys}
    os.environ["SKYPILOT_TPU_HOME"] = str(tmp_path_factory.mktemp("home"))
    # The balancer's routing key and cheap eligibility check read the
    # replicas' chunk from here.
    os.environ["SKYTPU_PREFILL_CHUNK"] = str(CHUNK)
    load_balancer._disagg_cache.clear()
    yield
    load_balancer._disagg_cache.clear()
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _start_fleet(name, engines, tiers):
    """Model servers over ``engines`` registered as a disaggregated
    service, behind the reference balancer. Returns (lb url, replica
    urls, stop)."""
    servers, urls = [], []
    for e in engines:
        port = _free_port()
        mod = ts if isinstance(e, te.InferenceEngine) else js
        model, httpd = mod.serve(e, host="127.0.0.1", port=port)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        assert model._ready.wait(timeout=300)
        servers.append((model, httpd))
        urls.append(f"http://127.0.0.1:{port}")
    n_pre = tiers.count("prefill")
    serve_state.add_service(name, {"disaggregation": {
        "prefill_replicas": n_pre,
        "decode_replicas": len(tiers) - n_pre}}, {}, 0)
    for i, (url, tier) in enumerate(zip(urls, tiers)):
        serve_state.upsert_replica(name, i + 1, f"{name}-r{i + 1}",
                                   serve_state.ReplicaStatus.READY, url,
                                   tier=tier)
    load_balancer._disagg_cache.clear()
    lb = load_balancer._ThreadingServer(
        ("127.0.0.1", 0),
        load_balancer.make_handler(name, load_balancer.LeastLoadPolicy()))
    threading.Thread(target=lb.serve_forever, daemon=True).start()

    def stop():
        lb.shutdown()
        lb.server_close()
        for model, httpd in servers:
            httpd.shutdown()
            httpd.server_close()
            model.shutdown()
        serve_state.remove_service(name)

    return f"http://127.0.0.1:{lb.server_address[1]}", urls, stop


@pytest.fixture(scope="module")
def fleet(models, fleet_env):
    """One prefill and two decode port replicas behind the reference
    balancer."""
    engines = [_port(models) for _ in range(3)]
    lb, urls, stop = _start_fleet("tdisagg", engines,
                                  ("prefill", "decode", "decode"))
    yield lb, urls, engines
    stop()


def _jax_single(models, prompt, n):
    return _jax(models).generate([prompt], n)[0]


def _handoffs(result):
    return load_balancer.LB_HANDOFFS.labels(result=result).value


def test_lb_two_tier_blocking_parity_and_no_leaks(models, fleet):
    """A blocking /generate through the balancer runs /prefill on the
    port prefill replica and /handoff on a port decode replica: the JAX
    engine's single-tier tokens, one handoff counted, and every tier
    holding only its resident entries' blocks."""
    lb, _, engines = fleet
    prompt = SYSTEM + [51, 52, 53]
    ok = _handoffs("ok")
    code, out = _post(f"{lb}/generate", {"tokens": prompt,
                                         "max_new_tokens": 6})
    assert code == 200 and "error" not in out
    assert out["tokens"] == _jax_single(models, prompt, 6)
    assert _handoffs("ok") == ok + 1
    for e in engines:
        assert _used(e) == _resident(e)
    assert sum(e.prefix_hits for e in engines[1:]) >= 1


def test_lb_short_prompt_falls_back_single_tier(models, fleet):
    lb, _, _ = fleet
    single = load_balancer.LB_TIER_REQUESTS.labels(tier="single").value
    prompt = [3, 1, 4]
    code, out = _post(f"{lb}/generate", {"tokens": prompt,
                                         "max_new_tokens": 4})
    assert code == 200 and out["tokens"] == _jax_single(models, prompt, 4)
    assert load_balancer.LB_TIER_REQUESTS.labels(
        tier="single").value == single + 1


def test_lb_two_tier_streaming_parity(models, fleet):
    """Streamed through the balancer: the committed token first, the
    whole sequence duplicate-free and equal to the JAX single-tier
    tokens, and the done line's ``n_tokens`` counting them."""
    lb, _, _ = fleet
    prompt = SYSTEM + [71, 72]
    toks, done = _stream(f"{lb}/generate", {"tokens": prompt,
                                            "max_new_tokens": 6})
    assert toks == _jax_single(models, prompt, 6)
    assert done is not None and done["n_tokens"] == len(toks) == 6


def test_lb_handoff_fault_retries_on_the_survivor(models, fleet):
    """The seeded ``handoff.transfer`` fault (a decode replica lost
    mid-transfer) retries the held export on the other decode replica:
    the same tokens, one retry and one handoff counted, no leaked
    block on any tier."""
    lb, _, engines = fleet
    prompt = SYSTEM + [91, 92, 93, 94]
    retry, ok = _handoffs("retry"), _handoffs("ok")
    chaos.configure({"seed": 3, "faults": [
        {"point": "handoff.transfer", "times": 1}]})
    try:
        code, out = _post(f"{lb}/generate", {"tokens": prompt,
                                             "max_new_tokens": 6})
        fired = chaos.injector().fired
    finally:
        chaos.deactivate()
    assert [f["point"] for f in fired] == ["handoff.transfer"]
    assert code == 200 and out["tokens"] == _jax_single(models, prompt, 6)
    assert (_handoffs("retry"), _handoffs("ok")) == (retry + 1, ok + 1)
    for e in engines:
        assert _used(e) == _resident(e)


def test_lb_mixed_fleet_jax_prefill_port_decode(models, fleet_env):
    """A JAX prefill replica before a port decode replica: the port
    imports the reference's wire, resumes over it (one prefix hit) and
    streams and returns the JAX single-tier tokens."""
    engines = [_jax(models), _port(models)]
    lb, _, stop = _start_fleet("tmixed", engines, ("prefill", "decode"))
    try:
        prompt = SYSTEM + [61, 62, 63]
        want = _jax_single(models, prompt, 6)
        code, out = _post(f"{lb}/generate", {"tokens": prompt,
                                             "max_new_tokens": 6})
        assert code == 200 and out["tokens"] == want
        assert engines[1].prefix_hits == 1
        prompt = SYSTEM + [64, 65]
        toks, done = _stream(f"{lb}/generate", {"tokens": prompt,
                                                "max_new_tokens": 5})
        assert toks == _jax_single(models, prompt, 5)
        assert done["n_tokens"] == 5 and engines[1].prefix_hits == 2
        assert _used(engines[1]) == _resident(engines[1])
    finally:
        stop()
