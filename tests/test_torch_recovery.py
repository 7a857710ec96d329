"""The port's engine crash recovery against the JAX package on the CPU,
in float32 at llama3-tiny, on the workloads of the reference's own
``tests/test_serve_recovery.py``: a seeded ``engine.dispatch`` fault at
each seam (admit, chunk, decode, verify) and one at ``kv.alloc`` reset
the engine, re-admit every in-flight request through the preemption
resume path, and finish with the JAX engine's uninterrupted greedy
tokens and the port's own, leaking no KV block, adapter pin or drafter
slot; ``skytpu_engine_recoveries_total`` moves by exactly the faults
fired. Then the server: the storm guard, the trailer's ``recoveries``
and the ``/metrics`` delta, an injected ``qos.shed``, ``adapter.load``
retried and exhausted, and the reference load balancer failing a
``replica.kill`` stream over to a second port replica.

Greedy speculation is exact, so the spec cells are held to the JAX
engine's spec-off tokens on the same (self-distilled) target. Where a
recovered run parts from a reference, the plain path's top-2 logit gap
at the first parting step must be at most 1e-2 (a near-tie): a resume
re-prefills its context through the chunk program where the
uninterrupted run decoded it. The JAX engine runs its Pallas paged
kernel in interpret mode (``kv_kernel=True``), the program the port's
kernel path is held to."""

import dataclasses
import itertools
import json
import socket
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import adapters as jad
from skypilot_tpu.infer import draft as jd
from skypilot_tpu.infer import engine as je
from skypilot_tpu.models import llama as jl
from skypilot_tpu.serve import load_balancer, serve_state
from skypilot_tpu_torch import chaos
from skypilot_tpu_torch.infer import adapters as tad
from skypilot_tpu_torch.infer import draft as td
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import kvcache as tkv
from skypilot_tpu_torch.infer import qos as tq
from skypilot_tpu_torch.infer import server as ts
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.observability import metrics as tm

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

PROMPT_LEN = 12     # > prefill_chunk: chunk-admitted, resume-covered
NEW_TOKENS = 8
RANK = 4
# The reference matrix's engine (without ``pad_waves``: the port
# dispatches each wave at its own size).
KW = dict(n_slots=2, max_len=48, prompt_buckets=(16,), prefill_chunk=8,
          prefix_pool=4, kv_block=16, max_wave=2)
# The admit seam's engine: short prompts, waves only.
ADMIT_KW = dict(n_slots=2, max_len=32, prompt_buckets=(8,), kv_block=16)
NEAR_TIE = 1e-2


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos._reset_for_tests()
    yield
    chaos._reset_for_tests()


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def distilled(models):
    """Self-distilled pairs (one draft layer) on both sides."""
    jcfg, tcfg, jp, tp = models
    return (jd.self_distilled_pair(jp, jcfg, 1),
            td.self_distilled_pair(tp, tcfg, 1))


def _prompts(vocab, n=3, length=PROMPT_LEN, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length).tolist() for _ in range(n)]


def _adapter_tree(cfg, seed):
    r = np.random.default_rng(seed)
    out = {}
    for t, (sa, sb) in tad.target_shapes(cfg, RANK).items():
        out[t] = {"a": r.normal(size=(cfg.n_layers,) + sa).astype(
            np.float32) * 0.05,
                  "b": r.normal(size=(cfg.n_layers,) + sb).astype(
            np.float32) * 0.05}
    return out


def _catalog(cfg, register=2, jax_side=False):
    if jax_side:
        cat = jad.AdapterCatalog(cfg, n_adapters=4, rank=RANK)
    else:
        cat = tad.AdapterCatalog(cfg, n_adapters=4, rank=RANK, device="cpu")
    for i in range(register):
        cat.register(f"ft-{i}", params=_adapter_tree(cfg, 100 + i))
    return cat


@pytest.fixture(scope="module")
def want(models, distilled):
    """The JAX engine's uninterrupted tokens, one run per (workload,
    int8 KV, self-distilled target, adapters), cached for the module."""
    jcfg, _, jp, _ = models
    cache = {}

    def get(kind="chunked", kv_int8=False, distill=False, adapters=False):
        key = (kind, kv_int8, distill, adapters)
        if key not in cache:
            params = distilled[0][0] if distill else jp
            if kind == "chunked":
                kw, prompts = dict(KW, kv_int8=kv_int8), _prompts(
                    jcfg.vocab_size)
            else:
                kw, prompts = ADMIT_KW, _prompts(jcfg.vocab_size,
                                                 length=4, seed=3)
            e = je.InferenceEngine(
                params, jcfg, kv_kernel=True,
                adapters=_catalog(jcfg, jax_side=True) if adapters
                else None, **kw)
            ids = [e.add_request(p, NEW_TOKENS,
                                 adapter="ft-0" if adapters else None)
                   for p in prompts]
            e.run_to_completion()
            by = {r.rid: r.tokens for r in e.finished}
            cache[key] = [list(by[i]) for i in ids]
        return cache[key]

    return get


def _port(models, distilled, kv_int8=False, spec=False, adapters=False,
          pipeline=None, **more):
    """(engine, catalog, draft engine) on the matrix's configuration."""
    _, tcfg, _, tp = models
    params, kw = tp, dict(KW, kv_int8=kv_int8, **more)
    de = None
    if spec:
        params, dparams, dcfg = distilled[1]
        de = td.DraftEngine(dparams, dcfg, n_slots=KW["n_slots"],
                            max_len=KW["max_len"], kv_int8=kv_int8,
                            device="cpu")
        kw.update(spec_k=4, draft_engine=de, spec_pipeline=pipeline)
    cat = _catalog(tcfg) if adapters else None
    e = te.InferenceEngine(params, tcfg, adapters=cat, device="cpu", **kw)
    return e, cat, de


def _drive(e, max_burst=4, max_steps=500, on_crash=None):
    """Run the engine dry, recovering through every typed dispatch
    crash. Returns the number of recoveries taken."""
    recovered = 0
    for _ in range(max_steps):
        if not (e.waiting or e.chunking or e.slot_req):
            return recovered
        try:
            e.step_burst(max_burst=max_burst)
        except te.EngineDispatchError as ex:
            if on_crash is not None:
                on_crash(ex)
            e.recover(ex)
            recovered += 1
    raise AssertionError("engine failed to drain")


def _run_batch(e, prompts, adapter=None, **kw):
    ids = [e.add_request(list(p), max_new_tokens=NEW_TOKENS,
                         adapter=adapter) for p in prompts]
    recovered = _drive(e, **kw)
    by_rid = {r.rid: r for r in e.finished}
    assert all(i in by_rid for i in ids)
    return [list(by_rid[i].tokens) for i in ids], recovered


def _recoveries_total():
    return sum(c.value for _, c in te.ENGINE_RECOVERIES.children())


def _first_gap(e, prompt, got, ref, adapter=None):
    """(step, the plain path's top-2 logit gap there) at the first step
    where ``got`` and ``ref`` part, or None where they agree. The gap is
    read from the float prefill program over the context, under the
    request's fine-tune."""
    t = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), None)
    if t is None:
        assert len(got) == len(ref)
        return None
    ctx = list(prompt) + list(ref[:t])
    lora, slot = {}, None
    if adapter is not None:
        slot = e.adapters.acquire(adapter)
        lora = {"lora": e.adapters.pool, "aid": torch.tensor([slot])}
    try:
        _, logits = tkv.prefill_batch(e.params, torch.tensor([ctx]),
                                      torch.tensor([len(ctx)]), e.cfg,
                                      plain_attention=True, **lora)
    finally:
        if slot is not None:
            e.adapters.release(slot)
    top = logits[0].topk(2).values
    return t, (top[0] - top[1]).item()


def _hold(e, prompts, got, ref, adapter=None):
    """``got`` equals ``ref`` per request, or parts only at a near-tie
    of the plain path (top-2 gap <= 1e-2)."""
    for p, g, r in zip(prompts, got, ref):
        assert len(g) == len(r) == NEW_TOKENS
        gap = _first_gap(e, p, g, r, adapter)
        assert gap is None or gap[1] <= NEAR_TIE, (g, r, gap)


def _no_leaks(e, cat=None, de=None):
    e.clear_prefix_cache()
    assert e.blocks_used() == 0
    assert all(not r.adapter_pinned for r in e.finished)
    if cat is not None:
        assert all(cat.pins(s) == 0 for s in range(cat.n_adapters))
    if de is not None:
        assert not any(de.claimed(s) for s in range(de.n_slots))
        assert de.blocks_used == 0


# -- the engine: every seam, against the JAX engine's uninterrupted run ------

@pytest.mark.parametrize(
    "kv_int8,spec,adapters", list(itertools.product((False, True),
                                                    repeat=3)),
    ids=lambda v: str(v))
def test_crash_resume_parity_matrix(models, distilled, want, kv_int8, spec,
                                    adapters):
    """A seeded fault at the decode (spec: verify) seam mid-run resets
    the engine and resumes every in-flight request: the tokens equal the
    port's uninterrupted run and the JAX engine's, each victim counts
    its recovery, the counter moves by one, and nothing leaks."""
    e, cat, de = _port(models, distilled, kv_int8, spec, adapters)
    prompts = _prompts(e.cfg.vocab_size)
    adapter = "ft-0" if adapters else None
    clean, _ = _run_batch(e, prompts, adapter=adapter)
    e.reset()
    e.clear_prefix_cache()

    seam = "verify" if spec else "decode"
    chaos.configure({"seed": 7, "faults": [
        {"point": "engine.dispatch", "match": {"seam": seam},
         "times": 1}]})
    before = _recoveries_total()
    got, recovered = _run_batch(e, prompts, adapter=adapter)
    inj = chaos.injector()
    chaos.deactivate()

    assert [f["ctx"]["seam"] for f in inj.fired] == [seam]
    assert recovered == 1 and _recoveries_total() == before + 1
    assert any(r.recoveries == 1 for r in e.finished)
    _hold(e, prompts, got, clean, adapter)
    _hold(e, prompts, got, want(kv_int8=kv_int8, distill=spec,
                                adapters=adapters), adapter)
    _no_leaks(e, cat, de)


def test_crash_at_admit_seam_recovers(models, distilled, want):
    """A fault at the admission wave (short prompts, no chunked
    prefill) is the same recoverable crash: the victims committed
    nothing and re-admit from scratch."""
    _, tcfg, _, tp = models
    prompts = _prompts(tcfg.vocab_size, length=4, seed=3)
    e = te.InferenceEngine(tp, tcfg, device="cpu", **ADMIT_KW)
    chaos.configure({"seed": 5, "faults": [
        {"point": "engine.dispatch", "match": {"seam": "admit"},
         "times": 1}]})
    before = _recoveries_total()
    got, recovered = _run_batch(e, prompts)
    fired = chaos.injector().fired
    chaos.deactivate()
    assert [f["ctx"]["seam"] for f in fired] == ["admit"]
    assert recovered == 1 and _recoveries_total() == before + 1
    _hold(e, prompts, got, want(kind="admit"))
    assert e.blocks_used() == 0


def test_kv_alloc_fault_recovers_typed(models, distilled, want):
    """A fault at the KV block allocation surfaces as the typed
    recoverable error of the seam around it (never a raw ChaosError),
    and the run finishes with the JAX engine's tokens."""
    e, _, _ = _port(models, distilled)
    prompts = _prompts(e.cfg.vocab_size)
    chaos.configure({"seed": 2, "faults": [
        {"point": "kv.alloc", "times": 1}]})
    seams = []
    before = _recoveries_total()
    got, recovered = _run_batch(
        e, prompts, on_crash=lambda ex: seams.append(
            (ex.seam, type(ex.cause).__name__)))
    fired = chaos.injector().fired
    chaos.deactivate()
    assert [f["point"] for f in fired] == ["kv.alloc"]
    assert seams == [("admit", "ChaosError")]
    assert recovered == 1 and _recoveries_total() == before + 1
    _hold(e, prompts, got, want())
    _no_leaks(e)


def test_crash_mid_chunk_releases_blocks_and_adapter_pins(models, distilled,
                                                          want):
    """Leak audit, a crash mid prefill chunk on an adapter engine: the
    JAX engine's tokens, and after the run the block pool is empty and
    no adapter pool slot stays pinned."""
    e, cat, _ = _port(models, distilled, adapters=True)
    prompts = _prompts(e.cfg.vocab_size)
    chaos.configure({"seed": 9, "faults": [
        {"point": "engine.dispatch", "match": {"seam": "chunk"},
         "after": 1, "times": 1}]})
    pinned = []
    before = _recoveries_total()
    got, recovered = _run_batch(
        e, prompts, adapter="ft-0",
        on_crash=lambda ex: pinned.append(
            sum(cat.pins(s) for s in range(cat.n_adapters))))
    chaos.deactivate()
    assert recovered == 1 and _recoveries_total() == before + 1
    assert pinned and pinned[0] > 0         # the crash held pins
    assert any(r.recoveries for r in e.finished)
    _hold(e, prompts, got, want(adapters=True), "ft-0")
    _no_leaks(e, cat)


def test_fault_with_a_pipelined_predraft_pending(models, distilled, want):
    """A verify fault while the pipelined predraft is still pending: the
    reset drops it, every block-table row of the engine and the
    drafter reads the sentinel before the next dispatch, and the run
    finishes with the JAX engine's tokens, no drafter slot left."""
    e, _, de = _port(models, distilled, spec=True, pipeline=True)
    prompts = _prompts(e.cfg.vocab_size)
    chaos.configure({"seed": 13, "faults": [
        {"point": "engine.dispatch", "match": {"seam": "verify"},
         "after": 2, "times": 1}]})
    seen = []
    real = e.recover

    def recover(ex):
        seen.append(de.stats()["pending"])
        n = real(ex)
        seen.append((de.stats()["pending"], len(de._state),
                     bool((e.block_table == e.n_kv_blocks).all()),
                     bool((de.block_table == de.n_kv_blocks).all()),
                     e._table_dirty, de._table_dirty, n > 0))
        return n

    e.recover = recover
    got, recovered = _run_batch(e, prompts)
    chaos.deactivate()
    assert recovered == 1
    assert seen[0] == 1                        # a predraft was pending
    assert seen[1] == (0, 0, True, True, True, True, True)
    _hold(e, prompts, got, want(distill=True))
    _no_leaks(e, de=de)


# -- the server: storm guard, trailer, metrics, sheds, adapter loads ---------

class _CrashLoopEngine:
    """An engine double that raises a recoverable device error on every
    decode burst while work is in flight; recover() re-queues the
    victims, so the crash repeats until the storm guard gives up."""

    spec_k = 1          # the server's synchronous decode path
    max_wave = None
    qos = None
    chunking = ()
    buckets = (16,)

    def __init__(self, n_slots=1):
        self.n_slots = n_slots
        self.waiting, self.slot_req, self.finished = [], {}, []
        self.free_slots = list(range(n_slots))
        self._rid = 0
        self.reset_calls = self.recover_calls = 0

    def check_kv_quota(self, *a):
        pass

    def check_adapter(self, name):
        pass

    def add_request(self, tokens, max_new, **kw):
        r = te.Request(rid=self._rid, prompt=list(tokens),
                       max_new_tokens=max_new)
        self._rid += 1
        self.waiting.append(r)
        return r.rid

    def admit(self, on_wave=None):
        while self.waiting and self.free_slots:
            r = self.waiting.pop(0)
            r.slot = self.free_slots.pop(0)
            r.tokens.append(7)
            self.slot_req[r.slot] = r

    def decode_burst(self, max_burst=8):
        if self.slot_req:
            raise te.EngineDispatchError("decode",
                                         RuntimeError("HBM parity storm"))
        return {}

    def generate(self, prompts, max_new_tokens=2):
        return [[1] * max_new_tokens for _ in prompts]

    def recover(self, exc=None):
        self.recover_calls += 1
        victims = list(self.slot_req.values())
        self.slot_req.clear()
        self.free_slots = list(range(self.n_slots))
        for r in victims:
            r.slot = None
            self.waiting.append(r)
        return len(victims)

    def reset(self):
        self.reset_calls += 1
        self.waiting.clear()
        self.slot_req.clear()
        self.finished.clear()
        self.free_slots = list(range(self.n_slots))


def test_recover_ledger_names_stall_recover(models):
    """Forensics, the twin of the reference's
    ``test_recover_ledger_names_stall_recover``: a crash victim's
    critical-path ledger names the requeued outage as a
    ``stall_recover`` phase and still sums to its wall; the engine wrote
    one ``recover`` record naming the seam and its victims."""
    from skypilot_tpu_torch.observability import flight as tfl
    from skypilot_tpu_torch.observability import forensics as tfo
    _, tcfg, _, tp = models
    e = te.InferenceEngine(tp, tcfg, n_slots=2, max_len=48,
                           prompt_buckets=(16,), prefill_chunk=8,
                           kv_block=16, device="cpu",
                           flight_recorder=tfl.FlightRecorder())
    chaos.configure({"seed": 21, "faults": [
        {"point": "engine.dispatch", "match": {"seam": "decode"},
         "times": 1}]})
    _run_batch(e, _prompts(tcfg.vocab_size, seed=6))
    chaos.deactivate()
    victims = [r for r in e.finished if r.recoveries >= 1]
    assert victims
    recs = e.flight.tail()
    (rec,) = [r for r in recs if r["burst"] == "recover"]
    assert rec["program"]["seam"] == "decode"
    assert {v.rid for v in victims} <= set(rec["rids"])
    ledger = tfo.ledger_from_records(victims[0].rid, recs)
    assert ledger is not None
    assert "stall_recover" in {p["phase"] for p in ledger["phases"]}
    total = sum(p["ms"] for p in ledger["phases"])
    assert total == pytest.approx(ledger["wall_ms"], abs=0.05)


def test_recovery_storm_guard_fails_over_to_reset(monkeypatch, capfd):
    """A crash loop does not recover forever: past the rolling-window
    limit the server fails the in-flight request and resets the engine,
    and stays ready."""
    monkeypatch.setenv("SKYTPU_RECOVERY_STORM_LIMIT", "2")
    fake = _CrashLoopEngine()
    model = ts.ModelServer(fake, max_burst=4)
    try:
        p = model._add([1], 8)
        assert p.event.wait(timeout=30)
        assert "error" in (p.result or {})
        assert fake.recover_calls == 2
        assert fake.reset_calls >= 1
        assert model._ready.is_set()
    finally:
        model.shutdown()
    events = [json.loads(ln)["name"] for ln in capfd.readouterr().err
              .splitlines() if ln.startswith('{"kind": "event"')]
    assert events.count("server.engine_recovered") == 2
    assert "server.recovery_storm" in events


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stream(url, payload):
    """Streamed /generate: (tokens, the done line)."""
    req = urllib.request.Request(
        url, data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    toks, done = [], None
    with urllib.request.urlopen(req, timeout=120) as r:
        for line in r:
            if not line.strip():
                continue
            obj = json.loads(line)
            assert "error" not in obj, obj
            if "done" in obj:
                done = obj
                break
            toks.extend(obj.get("tokens") or [])
    return toks, done


def _metric(url, name, **labels):
    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
        fams = tm.parse_exposition(r.read().decode())
    fam = fams.get(name) or {"samples": []}
    return sum(v for lab, v in fam["samples"]
               if all(lab.get(k) == w for k, w in labels.items()))


def _replica(engine, qos=None):
    port = _free_port()
    model, httpd = ts.serve(engine, host="127.0.0.1", port=port, qos=qos)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    model.wait_ready(timeout=120)

    def stop():
        httpd.shutdown()
        httpd.server_close()
        model.shutdown()

    return f"http://127.0.0.1:{port}", stop


@pytest.fixture(scope="module")
def replica(models):
    """A port replica with n-gram speculation, three fine-tunes (ft-0 to
    ft-2, none resident yet) and QoS admission (no rate limit)."""
    _, tcfg, _, tp = models
    cat = _catalog(tcfg, register=3)
    e = te.InferenceEngine(tp, tcfg, adapters=cat, device="cpu",
                           **dict(KW, spec_k=4))
    url, stop = _replica(e, qos=tq.AdmissionController(
        tq.QosConfig(enabled=True)))
    yield url, e
    stop()


def test_server_recovers_streams_with_trailers_and_metrics(models, want,
                                                           replica):
    """Three streamed requests and one verify fault: every stream
    completes with the JAX engine's tokens, a trailer counts the
    recovery, and ``skytpu_engine_recoveries_total`` moves by exactly
    one."""
    url, e = replica
    prompts = _prompts(e.cfg.vocab_size)
    before = _metric(url, "skytpu_engine_recoveries_total", seam="verify")
    chaos.configure({"seed": 4, "faults": [
        {"point": "engine.dispatch", "match": {"seam": "verify"},
         "after": 1, "times": 1}]})
    out = [None] * len(prompts)

    def one(i):
        out[i] = _stream(f"{url}/generate", {"tokens": prompts[i],
                                             "max_new_tokens": NEW_TOKENS})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    fired = chaos.injector().fired
    chaos.deactivate()
    assert len(fired) == 1
    assert all(o is not None and o[1] is not None for o in out)
    assert sum(o[1]["recoveries"] for o in out) >= 1
    assert all(o[1]["n_tokens"] == NEW_TOKENS for o in out)
    _hold(e, prompts, [o[0] for o in out], want())
    after = _metric(url, "skytpu_engine_recoveries_total", seam="verify")
    assert after == before + 1


def test_injected_qos_shed_is_a_typed_429(replica):
    """An injected ``qos.shed`` fault is a typed 429 shed with reason
    ``injected`` in ``/metrics``; the next request is admitted."""
    url, _ = replica
    before = _metric(url, "skytpu_qos_shed_total", reason="injected")
    chaos.configure({"seed": 0, "faults": [
        {"point": "qos.shed", "match": {"tenant": "hot"}, "times": 1}]})
    code, body = _post(f"{url}/generate",
                       {"tokens": [1, 2, 3], "max_new_tokens": 2},
                       headers={"x-skytpu-tenant": "hot"})
    code2, body2 = _post(f"{url}/generate",
                         {"tokens": [1, 2, 3], "max_new_tokens": 2},
                         headers={"x-skytpu-tenant": "hot"})
    chaos.deactivate()
    assert code == 429 and body["error"]["type"] == "rate_limited"
    assert body["error"]["tenant"] == "hot"
    assert _metric(url, "skytpu_qos_shed_total",
                   reason="injected") == before + 1
    assert code2 == 200 and len(body2["tokens"]) == 2


@pytest.mark.parametrize("times,adapter", [(1, "ft-1"), (2, "ft-2")])
def test_adapter_load_fault(replica, times, adapter):
    """``adapter.load`` failing once is retried and served under the
    fine-tune; failing on both attempts is the typed 503
    ``adapter_load_failed``, never the base model's tokens."""
    url, _ = replica
    chaos.configure({"seed": 0, "faults": [
        {"point": "adapter.load", "match": {"adapter": adapter},
         "times": times, "error": "OSError",
         "message": "injected load fault"}]})
    code, body = _post(f"{url}/generate", {"tokens": [5, 6, 7],
                                           "max_new_tokens": 3,
                                           "model": adapter})
    fired = chaos.injector().fired
    chaos.deactivate()
    assert len(fired) == times
    if times == 1:
        assert code == 200 and body["model"] == adapter
        assert len(body["tokens"]) == 3
    else:
        assert code == 503
        assert body["error"]["type"] == "adapter_load_failed"
        assert body["error"]["adapter"] == adapter


def test_lb_fails_a_killed_stream_over_gapless(models, want, tmp_path,
                                               monkeypatch):
    """Two port replicas behind the reference load balancer; a
    ``replica.kill`` fault drops the first stream after two chunks with
    no terminal line. The balancer replays prompt plus committed tokens
    on the survivor: one gapless stream with the JAX engine's tokens
    and one failover counted."""
    monkeypatch.setenv("SKYPILOT_TPU_HOME", str(tmp_path / "home"))
    _, tcfg, _, tp = models
    # Buckets up to 32: the replay carries prompt plus committed tokens.
    replicas = [_replica(te.InferenceEngine(
        tp, tcfg, device="cpu", **dict(KW, prompt_buckets=(16, 32))))
                for _ in range(2)]
    serve_state.add_service("trec", {}, {}, 0)
    for i, (url, _) in enumerate(replicas):
        serve_state.upsert_replica("trec", i + 1, f"trec-r{i + 1}",
                                   serve_state.ReplicaStatus.READY, url)
    lb = load_balancer._ThreadingServer(
        ("127.0.0.1", 0),
        load_balancer.make_handler("trec", load_balancer.LeastLoadPolicy()))
    threading.Thread(target=lb.serve_forever, daemon=True).start()
    try:
        prompt = _prompts(tcfg.vocab_size, n=1)[0]
        fo = load_balancer.LB_FAILOVERS.labels(phase="mid_stream").value
        chaos.configure({"seed": 1, "faults": [
            {"point": "replica.kill", "after": 2, "times": 1}]})
        toks, done = _stream(
            f"http://127.0.0.1:{lb.server_address[1]}/generate",
            {"tokens": prompt, "max_new_tokens": NEW_TOKENS})
        fired = chaos.injector().fired
        chaos.deactivate()
        assert [f["point"] for f in fired] == ["replica.kill"]
        assert done["failovers"] == 1 and done["n_tokens"] == NEW_TOKENS
        assert load_balancer.LB_FAILOVERS.labels(
            phase="mid_stream").value == fo + 1
        e = te.InferenceEngine(tp, tcfg, device="cpu", **KW)
        _hold(e, [prompt], [toks], [want()[0]])
    finally:
        lb.shutdown()
        lb.server_close()
        for _, stop in replicas:
            stop()
        serve_state.remove_service("trec")
