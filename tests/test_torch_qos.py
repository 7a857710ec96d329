"""The port's multi-tenant QoS, preemption, per-tenant KV quota and lazy
KV growth against the JAX package on the CPU, in float32 at
llama3-tiny, on the workloads of the reference's own tests
(``tests/test_qos.py``, ``tests/test_span_attn.py``): the JAX engine and
the port get the same weights through ``llama.params_from_numpy``.

The JAX engine runs its Pallas paged kernel in interpret mode
(``kv_kernel=True``), the program the port's kernel path is held to.
The port's pool is given the reference's default size, ``(slots + 1)``
max_len rows of blocks (the reference keeps a spare slot for wave
padding; the port does not, so its own default is one row fewer): on a
one-slot engine that one block is what keeps the victim's stored prefix
resident while the high-priority request runs."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as je
from skypilot_tpu.infer import qos as jq
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import qos as tq
from skypilot_tpu_torch.models import llama as tl

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

LOW_PROMPT = list(range(5, 17))


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


def _port(tp, tcfg, n_slots=1, kv_int8=False, spec_k=0, pool=4,
          qos=True, **kw):
    """The reference's ``_qos_engine`` (one slot, max_len 64, chunks of
    8, a prefix pool of 4), at the reference's pool size."""
    kw.setdefault("kv_blocks", n_slots + 1)
    return te.InferenceEngine(
        tp, tcfg, n_slots=n_slots, max_len=64, prompt_buckets=(48,),
        prefill_chunk=8, prefix_pool=pool, kv_int8=kv_int8, spec_k=spec_k,
        qos=tq.FairScheduler() if qos else None, device="cpu", **kw)


def _preempt_mid_decode(e, prompt, max_new, bursts=2):
    """The reference's preemption workload: the low-priority request
    runs alone, decodes ``bursts`` bursts of 2, then a priority-1
    request arrives; returns (the low request, every finished one)."""
    rid = e.add_request(prompt, max_new_tokens=max_new, priority=0)
    while not e.slot_req:
        e.step_burst(max_burst=2)
    for _ in range(bursts):
        e.decode_burst(max_burst=2)
    e.add_request([3, 1, 4], max_new_tokens=4, priority=1)
    e.run_to_completion(max_burst=2)
    by_rid = {r.rid: r for r in e.finished}
    return by_rid[rid], by_rid


def _req(mod, rid, tenant="default", priority=0, prompt_len=4, max_new=4):
    return mod.Request(rid=rid, prompt=list(range(1, prompt_len + 1)),
                       max_new_tokens=max_new, tenant=tenant,
                       priority=priority)


# -- the preemption matrix ---------------------------------------------------

@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8kv"])
@pytest.mark.parametrize("spec_k", [0, 4])
def test_preempt_resume_matches_jax_engine(models, kv_int8, spec_k):
    """``tests/test_qos.py::test_preempt_resume_bit_identical``: the
    low-priority request, preempted mid-decode and resumed warm from the
    prefix cache, gives the JAX engine's tokens (preempted on the same
    workload) and the port's unpreempted run's; one preemption, a warm
    resume of at least one chunk, the same resumed rows as the JAX
    engine, and no block left after the cache is cleared."""
    jcfg, tcfg, jp, tp = models
    ref = je.InferenceEngine(
        jp, jcfg, n_slots=1, max_len=64, prompt_buckets=(48,),
        prefill_chunk=8, prefix_pool=4, kv_int8=kv_int8, spec_k=spec_k,
        kv_kernel=True, qos=jq.FairScheduler())
    jlow, _ = _preempt_mid_decode(ref, LOW_PROMPT, 14)
    solo = _port(tp, tcfg, kv_int8=kv_int8, spec_k=spec_k, qos=False)
    want = solo.generate([LOW_PROMPT], max_new_tokens=14)[0]
    e = _port(tp, tcfg, kv_int8=kv_int8, spec_k=spec_k)
    low, _ = _preempt_mid_decode(e, LOW_PROMPT, 14)
    assert low.tokens == jlow.tokens == want
    assert low.preemptions == jlow.preemptions == 1
    assert low.resumed_len == jlow.resumed_len >= 8
    e.clear_prefix_cache()
    assert e.allocator.used == 0


def test_preempt_cold_resume_without_prefix_cache(models):
    """No prefix index: the eviction stores nothing and the resume
    re-prefills the whole context, with the same tokens."""
    _, tcfg, _, tp = models
    want = _port(tp, tcfg, pool=0, qos=False).generate(
        [LOW_PROMPT], max_new_tokens=12)[0]
    e = _port(tp, tcfg, pool=0)
    low, _ = _preempt_mid_decode(e, LOW_PROMPT, 12, bursts=1)
    assert (low.preemptions, low.resumed_len) == (1, 0)
    assert low.tokens == want
    e.clear_prefix_cache()
    assert e.allocator.used == 0


def test_preempt_wave_admitted_victim_resumes_cold(models):
    """A wave-admitted victim (prompt no longer than the chunk) is
    preemptible only once its context outgrows the chunk (its resume
    must take the chunk path), and its wave-program rows never enter
    the shared prefix cache: it resumes cold, with the same tokens."""
    _, tcfg, _, tp = models
    prompt = [5, 6, 7, 8, 9, 10]
    want = _port(tp, tcfg, qos=False).generate([prompt],
                                               max_new_tokens=12)[0]
    e = _port(tp, tcfg)
    rid = e.add_request(prompt, max_new_tokens=12)
    while not e.slot_req:
        e.step_burst(max_burst=2)
    (slot,) = e.slot_req
    while e._ctx_len(e.slot_req[slot]) <= e.prefill_chunk:
        assert e.preempt_slot(slot) is False      # still wave-sized
        e.decode_burst(max_burst=2)
    e.add_request([3, 1, 4], max_new_tokens=4, priority=1)
    e.run_to_completion(max_burst=2)
    low = {r.rid: r for r in e.finished}[rid]
    assert (low.preemptions, low.resumed_len) == (1, 0)
    assert low.tokens == want
    e.clear_prefix_cache()
    assert e.allocator.used == 0


def test_no_preemption_within_equal_priority(models):
    _, tcfg, _, tp = models
    e = _port(tp, tcfg)
    e.add_request(LOW_PROMPT, max_new_tokens=12, priority=0)
    while not e.slot_req:
        e.step_burst(max_burst=2)
    e.add_request([3, 1, 4], max_new_tokens=4, priority=0)
    e.admit()
    (resident,) = e.slot_req.values()
    assert resident.preemptions == 0 and len(e.waiting) == 1
    e.run_to_completion(max_burst=2)
    assert all(r.preemptions == 0 for r in e.finished)


def test_preempt_refuses_while_burst_in_flight(models):
    """An un-fetched burst would commit tokens into a re-queued request:
    preemption waits for ``complete_decode_burst``. The eviction counts
    once under the victim's tenant label."""
    _, tcfg, _, tp = models
    e = _port(tp, tcfg)
    e.add_request(LOW_PROMPT, max_new_tokens=12, tenant="victim")
    while not e.slot_req:
        e.step_burst(max_burst=2)
    (slot,) = e.slot_req
    counter = tq.QOS_PREEMPTIONS.labels(tenant=tq.tenant_label("victim"))
    before = counter.value
    handle = e.dispatch_decode_burst(max_burst=2)
    assert handle is not None
    assert e.preempt_slot(slot) is False
    e.complete_decode_burst(handle)
    assert e.preempt_slot(slot) is True
    assert counter.value == before + 1
    assert (e.block_table[slot] == e.n_kv_blocks).all()
    e.run_to_completion(max_burst=2)
    e.clear_prefix_cache()
    assert e.allocator.used == 0


def test_stored_blocks_survive_the_burst_after_a_preemption(models):
    """The victim's trailing partial block is shared with the prefix
    cache without a copy; the next bursts' flush for the freed slot
    (rows at its unchanged device length, inside that block) must land
    in the trash block, so the stored entry's block bytes are unchanged
    after them. Blocks of 16 rows, chunks of 8: the victim is preempted
    at a context of 25-32 rows, so 24 rows are stored and the second
    block is partial."""
    _, tcfg, _, tp = models
    e = _port(tp, tcfg, n_slots=2, kv_block=16, kv_blocks=12)
    e.add_request(LOW_PROMPT, max_new_tokens=40, priority=0)
    e.add_request(list(range(30, 42)), max_new_tokens=40, priority=0)
    while len(e.slot_req) < 2 or e.chunking:
        e.step_burst(max_burst=1)
    victim = max(e.slot_req, key=lambda s: e.slot_req[s].rid)
    while e._ctx_len(e.slot_req[victim]) < 25:
        e.decode_burst(max_burst=1)
    ctx = e.slot_req[victim].prompt + e.slot_req[victim].tokens
    assert len(ctx) <= 32 and e.preempt_slot(victim)
    payload, cached = e._prefix_index.lookup(ctx)
    assert cached == 24 and len(payload) == 2
    ids = torch.tensor(payload)
    before = {n: e.cache[n][:, ids].clone() for n in ("k", "v")}
    for _ in range(3):                     # the other slot decodes on
        e.decode_burst(max_burst=2)
    for n in ("k", "v"):
        assert torch.equal(e.cache[n][:, ids], before[n])
    e.run_to_completion(max_burst=2)
    e.clear_prefix_cache()
    assert e.allocator.used == 0


def test_server_loop_preempts_on_saturated_replica(models):
    """The serving loop reaches the priority-preemption pass with no
    free slot (admission is its only entry point): over the port's
    ``ModelServer`` the resident is preempted once and keeps its
    unpreempted tokens."""
    import threading
    import time

    from skypilot_tpu_torch.infer import server as ts
    _, tcfg, _, tp = models
    want = _port(tp, tcfg, qos=False).generate([LOW_PROMPT],
                                               max_new_tokens=14)[0]
    model = ts.ModelServer(_port(tp, tcfg))
    try:
        model.wait_ready(timeout=120)
        results = {}

        def run(name, tokens, mnt, prio):
            results[name] = model.submit(tokens, mnt, priority=prio)

        t_low = threading.Thread(target=run,
                                 args=("low", LOW_PROMPT, 14, 0))
        t_low.start()
        deadline = time.monotonic() + 60
        while not model.engine.slot_req and time.monotonic() < deadline:
            time.sleep(0.005)
        t_hi = threading.Thread(target=run, args=("hi", [3, 1, 4], 4, 1))
        t_hi.start()
        t_hi.join(timeout=120)
        t_low.join(timeout=120)
        assert results["low"]["preemptions"] == 1
        assert results["low"]["tokens"] == want
        assert len(results["hi"]["tokens"]) == 4
    finally:
        model.shutdown()


# -- the fair scheduler and admission control --------------------------------

def _sequences():
    """The reference tests' waiting queues (``tests/test_qos.py:65-115``)
    as (config, quantum, [(rid, tenant, priority, prompt_len)])."""
    paid = {"paid": dict(weight=2), "free": dict(weight=1)}
    rng = np.random.default_rng(7)
    mixed = [(i, f"t{rng.integers(0, 3)}", int(rng.integers(-1, 2)),
              int(rng.integers(1, 40))) for i in range(24)]
    return {
        "hot_and_background": (None, 8, [(i, "hot", 0, 4) for i in range(6)]
                               + [(10, "bg", 0, 4)]),
        "weights": (paid, 8, [(i, "paid", 0, 4) for i in range(4)]
                    + [(10 + i, "free", 0, 4) for i in range(4)]),
        "priority_lanes": (None, None, [(0, "a", 0, 4), (1, "b", 0, 4),
                                        (2, "a", 1, 4)]),
        "single_lane_fifo": (None, None, [(i, "default", 0, 4)
                                          for i in range(5)]),
        "mixed": (paid, 16, mixed),
    }


@pytest.mark.parametrize("name", sorted(_sequences()))
def test_fair_scheduler_orders_as_the_reference(name):
    """The port's ``FairScheduler.reorder`` gives the reference's order on
    the same queue, over three passes that each admit the head (the
    rotation follows service)."""
    tenants, quantum, reqs = _sequences()[name]
    orders = []
    for mod, eng in ((tq, te), (jq, je)):
        cfg = mod.QosConfig(enabled=True, tenants={
            t: mod.TenantSpec(**kw) for t, kw in (tenants or {}).items()})
        sched = mod.FairScheduler(cfg, quantum=quantum)
        waiting = collections.deque(
            _req(eng, rid, tenant, prio, n) for rid, tenant, prio, n in reqs)
        seen = []
        for _ in range(3):
            sched.reorder(waiting)
            seen.append([r.rid for r in waiting])
            waiting.popleft()
        orders.append(seen)
    assert orders[0] == orders[1]


def test_admission_and_identity_match_the_reference():
    """Token buckets, the typed 429/503 sheds and ``Retry-After``,
    ``request_identity`` and the env config: the port's copy gives the
    reference's answers."""
    for mod in (tq, jq):
        b = mod.TokenBucket(rate=2.0, burst=2.0, now=0.0)
        assert [b.take(now=0.0) for _ in range(3)] == [0.0, 0.0, 0.5]
    shed = []
    for mod in (tq, jq):
        ac = mod.AdmissionController(mod.QosConfig(
            enabled=True, default_rate=1.0, default_burst=1.0,
            max_waiting=2), where="server")
        ac.admit("hot", depth=0)
        with pytest.raises(mod.RateLimitedError) as rl:
            ac.admit("hot", depth=0)
        with pytest.raises(mod.OverloadedError) as ov:
            ac.admit("bg", depth=2)
        body = dict(rl.value.typed_error)
        assert body.pop("retry_after_ms") > 0
        body.pop("message")
        shed.append((rl.value.http_status, body,
                     rl.value.retry_after_header(), ov.value.http_status,
                     ov.value.typed_error, ov.value.retry_after_header()))
    assert shed[0] == shed[1]
    cfgs = [mod.QosConfig(enabled=True, tenants={
        "bulk": mod.TenantSpec(priority=-1)}) for mod in (tq, jq)]
    for headers, body, c in [
            ({"x-skytpu-tenant": "acme", "x-skytpu-priority": "2"}, {}, 0),
            ({}, {"tenant": "sdk", "priority": 99}, None),
            ({}, {"tenant": "bulk"}, 0),
            ({"x-skytpu-tenant": "   "}, {}, None),
            ({"x-skytpu-tenant": "bulk", "x-skytpu-priority": "9"}, {}, 0),
            ({"x-skytpu-tenant": "fresh", "x-skytpu-priority": "9"}, {}, 0)]:
        got = [mod.request_identity(
            headers, body, cfg=None if c is None else cfgs[i])
            for i, mod in enumerate((tq, jq))]
        assert got[0] == got[1], (headers, body)


def test_qos_config_reads_the_reference_env(monkeypatch):
    monkeypatch.setenv("SKYTPU_QOS", "1")
    monkeypatch.setenv("SKYTPU_QOS_RATE", "3")
    monkeypatch.setenv("SKYTPU_QOS_MAX_WAITING", "7")
    monkeypatch.setenv("SKYTPU_QOS_QUANTUM", "64")
    monkeypatch.setenv("SKYTPU_QOS_TENANTS",
                       '{"free": {"rate": 2, "max_kv_blocks": 64}}')
    port, ref = tq.QosConfig.from_env(), jq.QosConfig.from_env()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.tenant("free").max_kv_blocks == 64
    assert tq.admission_from_env("server").where == "server"
    assert tq.scheduler_from_env().quantum == 64
    monkeypatch.setenv("SKYTPU_QOS", "0")
    assert tq.admission_from_env() is None and tq.scheduler_from_env() is None


def test_wfq_admits_background_ahead_of_flood(models):
    """Six hot requests queued before one background request: with the
    fair scheduler the background tenant rides the first admission
    pass, as in the JAX engine; FIFO strands it."""
    _, tcfg, _, tp = models
    admitted = []
    for qos in (True, False):
        e = te.InferenceEngine(tp, tcfg, n_slots=2, max_len=64,
                               prompt_buckets=(16,), device="cpu",
                               qos=tq.FairScheduler() if qos else None)
        for i in range(6):
            e.add_request([1 + i, 2, 3], max_new_tokens=8, tenant="hot")
        e.add_request([9, 9, 9], max_new_tokens=8, tenant="background")
        e.admit()
        admitted.append(sorted(r.tenant for r in e.slot_req.values()))
        e.run_to_completion(max_burst=4)
        assert len(e.finished) == 7
    assert admitted == [["background", "hot"], ["hot", "hot"]]


def test_requeue_updates_waiting_gauge(models):
    _, tcfg, _, tp = models
    e = te.InferenceEngine(tp, tcfg, n_slots=1, max_len=64,
                           prompt_buckets=(16,), device="cpu")
    e._requeue(_req(te, 0))
    assert len(e.waiting) == 1
    assert te.ENGINE_WAITING._require_default().value == 1
    e.waiting.clear()
    e._update_gauges()
    assert te.ENGINE_WAITING._require_default().value == 0


# -- lazy KV growth ----------------------------------------------------------

def _lazy_prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, n).tolist() for n in (5, 9)]


def test_lazy_reserves_less_grows_and_matches_eager(models):
    """``tests/test_span_attn.py::test_lazy_reserves_less_and_grows``:
    lazy admission reserves the prompt plus one burst of rows, not the
    full budget; bursts grow the tables (``skytpu_kv_lazy_grows_total``
    rises); every grown block is released at retirement; and the lazy
    tokens are the eager engine's and the JAX engine's on the same
    schedule (admit, chunk, bursts of 4: in the kernel path the staged
    columns are bf16 products, so tokens may part at top-2 gaps below
    ~1e-2 between schedules, as the reference's do)."""
    jcfg, tcfg, jp, tp = models
    prompts = _lazy_prompts(tcfg.vocab_size)

    def admit_only(e):
        for p in prompts:
            e.add_request(p, max_new_tokens=40)
        e.admit()
        while e.chunking:
            e.prefill_chunk_step()
        return e

    def port(kv_lazy):
        return admit_only(te.InferenceEngine(
            tp, tcfg, n_slots=2, max_len=64, prompt_buckets=(16, 32, 64),
            kv_block=8, prefill_chunk=8, kv_lazy=kv_lazy, device="cpu"))

    grows = te.KV_LAZY_GROWS._require_default()
    g0 = grows.value
    lazy, eager = port(True), port(False)
    ref = admit_only(je.InferenceEngine(
        jp, jcfg, n_slots=2, max_len=64, prompt_buckets=(16, 32, 64),
        kv_block=8, prefill_chunk=8, prefix_pool=0, spec_k=0,
        kv_kernel=True, kv_lazy=True))
    assert lazy.kv_lazy and not eager.kv_lazy
    assert 0 < lazy.blocks_used() == ref.blocks_used < eager.blocks_used()
    outs = []
    for e in (lazy, eager, ref):
        while e.slot_req:
            e.decode_burst(max_burst=4)
        assert (e.blocks_used() if e is not ref else e.blocks_used) == 0
        outs.append([r.tokens for r in sorted(e.finished,
                                              key=lambda r: r.rid)])
    assert outs[0] == outs[1] == outs[2]
    assert grows.value > g0


def test_lazy_dry_pool_sits_a_slot_out(models):
    """A pool of 12 blocks of 8 rows, too small for both slots' growth:
    the slot that cannot grow sits bursts out (inactive, its device
    length unchanged) while the other decodes and retires, and no active
    slot ever has a row below its length without a block; then it grows
    and finishes with the eager engine's tokens. Bursts of one token, so
    that sitting out moves no token between the staged and the cached
    columns (whose products round differently)."""
    _, tcfg, _, tp = models
    prompts = _lazy_prompts(tcfg.vocab_size)
    outs, sat_out = [], 0
    for kv_lazy, kv_blocks in ((False, None), (True, 12)):
        e = te.InferenceEngine(tp, tcfg, n_slots=2, max_len=64,
                               prompt_buckets=(16,), kv_block=8,
                               kv_blocks=kv_blocks, kv_lazy=kv_lazy,
                               device="cpu")
        for p in prompts:
            e.add_request(p, max_new_tokens=40)
        while e.waiting or e.slot_req:
            e.admit()
            lens = e.cache["length"].clone()
            e.decode_burst(max_burst=1)
            for slot in e.slot_req:
                n = int(e.cache["length"][slot])
                sat_out += n == int(lens[slot])
                have = int((e.block_table[slot] < e.n_kv_blocks).sum())
                assert have * e.kv_block >= n
        outs.append([r.tokens for r in sorted(e.finished,
                                              key=lambda r: r.rid)])
        assert e.blocks_used() == 0
    assert sat_out > 0
    assert outs[0] == outs[1]


def test_lazy_wedge_raises_typed(models):
    """Every active slot needs a block the pool cannot give and nothing
    can retire: ``run_to_completion`` raises the typed wedge error
    instead of spinning."""
    _, tcfg, _, tp = models
    e = te.InferenceEngine(tp, tcfg, n_slots=2, max_len=64,
                           prompt_buckets=(16,), kv_block=8, kv_blocks=8,
                           kv_lazy=True, device="cpu")
    for p in _lazy_prompts(tcfg.vocab_size):
        e.add_request(p, max_new_tokens=50)
    with pytest.raises(te.KvPoolWedgedError) as ei:
        e.run_to_completion(max_burst=4)
    assert ei.value.typed_error["type"] == "kv_pool_wedged"


def test_lazy_env_knob(models, monkeypatch):
    _, tcfg, _, tp = models
    monkeypatch.setenv("SKYTPU_KV_LAZY", "1")
    e = te.InferenceEngine(tp, tcfg, n_slots=1, max_len=64,
                           prompt_buckets=(16,), device="cpu")
    assert e.kv_lazy and e._lazy_headroom == 16
    assert not te.InferenceEngine(tp, tcfg, n_slots=1, max_len=64,
                                  prompt_buckets=(16,), device="cpu",
                                  kv_lazy=False).kv_lazy


# -- per-tenant KV-block quotas ----------------------------------------------

def _quota_engine(tp, tcfg, tenants, n_slots=3):
    qcfg = tq.QosConfig(enabled=True, tenants={
        t: tq.TenantSpec(max_kv_blocks=n) for t, n in tenants.items()})
    return te.InferenceEngine(tp, tcfg, n_slots=n_slots, max_len=64,
                              prompt_buckets=(16,), kv_block=16,
                              prefix_pool=0, device="cpu",
                              qos=tq.FairScheduler(qcfg))


def test_kv_quota_stalls_tenant_not_queue(models):
    """``tests/test_qos.py::test_kv_quota_stalls_tenant_not_queue``: a
    tenant at its quota steps aside (its counter fires once per
    episode) while another tenant admits; its own retirement unblocks
    it, and the charges drain to zero."""
    _, tcfg, _, tp = models
    e = _quota_engine(tp, tcfg, {"hog": 1})
    stalls = te.QOS_KV_QUOTA_STALLS.labels(tenant="hog")
    before = stalls.value
    e.add_request([1, 2, 3], max_new_tokens=4, tenant="hog")
    e.add_request([4, 5, 6], max_new_tokens=4, tenant="hog")
    e.add_request([7, 8, 9], max_new_tokens=4, tenant="bg")
    e.admit()
    assert sorted(r.tenant for r in e.slot_req.values()) == ["bg", "hog"]
    assert len(e.waiting) == 1 and e.waiting[0].kv_quota_stalled
    assert e._tenant_kv["hog"] == 1
    assert te.QOS_KV_BLOCKS.labels(tenant="hog").value == 1
    assert stalls.value == before + 1
    e.admit()
    assert stalls.value == before + 1           # once per episode
    assert len(e.run_to_completion(max_burst=4)) == 3
    assert not e.waiting and not e.slot_req and not e._tenant_kv
    assert te.QOS_KV_BLOCKS.labels(tenant="hog").value == 0
    stalled = [r for r in e.finished if r.stall_ms]
    assert [set(r.stall_ms) for r in stalled] == [{"kv_quota"}]


def test_kv_quota_unsatisfiable_is_the_reference_typed_400(models):
    """A request whose own worst-case need exceeds its tenant's quota is
    refused at submit with the reference's typed body; other tenants
    are untouched."""
    jcfg, tcfg, jp, tp = models
    e = _quota_engine(tp, tcfg, {"hog": 1}, n_slots=2)
    ref = je.InferenceEngine(
        jp, jcfg, n_slots=2, max_len=64, prompt_buckets=(16,), kv_block=16,
        prefix_pool=0, qos=jq.FairScheduler(jq.QosConfig(
            enabled=True, tenants={"hog": jq.TenantSpec(max_kv_blocks=1)})))
    bodies = []
    for eng in (e, ref):
        with pytest.raises(ValueError) as ei:
            eng.add_request([1, 2, 3], max_new_tokens=60, tenant="hog")
        bodies.append(ei.value.typed_error)
        assert not eng.waiting
    assert bodies[0] == bodies[1]
    assert bodies[0]["type"] == "kv_quota_unsatisfiable"
    e.add_request([1, 2, 3], max_new_tokens=60, tenant="bg")
    e.admit()
    assert len(e.slot_req) == 1


def test_kv_quota_unconfigured_tenant_unlimited(models):
    _, tcfg, _, tp = models
    e = _quota_engine(tp, tcfg, {}, n_slots=2)
    for i in range(2):
        e.add_request([1 + i, 2, 3], max_new_tokens=4, tenant="any")
    e.admit()
    assert len(e.slot_req) == 2 and not e.waiting
