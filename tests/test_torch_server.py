"""The port's HTTP server on the CPU: blocking and streamed /generate
return the JAX engine's greedy tokens, the response keys are the
reference server's, an oversize prompt gets the reference's typed 400
body, prompts longer than the prefill chunk go through chunks, with
the reference trailer's ``prefill_chunks``, and a shared-prefix pair
through a server with the prefix cache and speculation on reports the
JAX server's trailer values. The operator surface: ``/healthz``,
``/metrics`` (parsed by the reference's ``parse_exposition``, under the
reference registry's names) and ``POST /drain`` (the reference's drain
lifecycle, and its controller's drain poll, against a port replica),
and the typed 400/409/411/429/503 bodies and ``Retry-After`` beside the
reference server's."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as je
from skypilot_tpu.infer import qos as jq
from skypilot_tpu.infer import server as js
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import qos as tq
from skypilot_tpu_torch.infer import server as ts
from skypilot_tpu_torch.models import llama as tl

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The reference server's response keys for /generate (blocking result
# and the stream's closing line).
_BLOCKING_KEYS = {"tokens", "ttft_ms", "cache_hit", "cached_tokens",
                  "prefill_chunks", "spec_drafted", "spec_accepted",
                  "drafter", "preemptions", "recoveries", "model",
                  "total_ms"}
_DONE_KEYS = {"done", "ttft_ms", "n_tokens", "cache_hit", "cached_tokens",
              "spec_drafted", "spec_accepted", "drafter", "preemptions",
              "recoveries"}


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
            body = r.read()
            if payload.get("stream"):
                return r.status, [json.loads(x) for x in body.splitlines()
                                  if x.strip()]
            return r.status, json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served():
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 512, n).tolist() for n in (4, 13, 21)]
    ref = je.InferenceEngine(jp, jcfg, n_slots=2, max_len=64,
                             prompt_buckets=(16, 32), kv_block=16,
                             prefill_chunk=0, prefix_pool=0, spec_k=0,
                             kv_kernel=True)
    want = ref.generate(prompts, max_new_tokens=6)
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    engine = te.InferenceEngine(tp, tcfg, n_slots=2, max_len=64,
                                prompt_buckets=(16, 32), kv_block=16,
                                device="cpu")
    port = _free_port()
    model, httpd = ts.serve(engine, host="127.0.0.1", port=port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    model.wait_ready(timeout=120)
    yield f"http://127.0.0.1:{port}", prompts, want
    httpd.shutdown()
    model.shutdown()
    t.join(timeout=30)


@pytest.fixture(scope="module")
def served_chunked():
    """A server whose engine prefills prompts longer than 8 tokens in
    chunks of 8, beside the JAX engine's tokens and chunk counts for the
    same prompts (what the reference trailer reports)."""
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, n).tolist() for n in (27, 5, 17)]
    ref = je.InferenceEngine(jp, jcfg, n_slots=2, max_len=64,
                             prompt_buckets=(16, 32), kv_block=16,
                             prefill_chunk=8, prefix_pool=0, spec_k=0,
                             kv_kernel=True)
    want = ref.generate(prompts, max_new_tokens=6)
    chunks = [r.n_chunks for r in sorted(ref.finished, key=lambda r: r.rid)]
    tp = tl.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    engine = te.InferenceEngine(tp, tcfg, n_slots=2, max_len=64,
                                prompt_buckets=(16, 32), kv_block=16,
                                prefill_chunk=8, device="cpu")
    port = _free_port()
    model, httpd = ts.serve(engine, host="127.0.0.1", port=port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    model.wait_ready(timeout=120)
    yield f"http://127.0.0.1:{port}", prompts, want, chunks
    httpd.shutdown()
    model.shutdown()
    t.join(timeout=30)


def test_health(served):
    url, _, _ = served
    with urllib.request.urlopen(f"{url}/health", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}


def test_blocking_generate_matches_jax_engine(served):
    url, prompts, want = served
    results = {}

    def one(i):
        results[i] = _post(f"{url}/generate",
                           {"tokens": prompts[i], "max_new_tokens": 6})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    for i in range(len(prompts)):
        code, out = results[i]
        assert code == 200
        assert out["tokens"] == want[i]
        assert set(out) == _BLOCKING_KEYS
        assert out["ttft_ms"] is not None and out["total_ms"] > 0


def test_stream_generate_matches_jax_engine(served):
    url, prompts, want = served
    code, chunks = _post(f"{url}/generate",
                         {"tokens": prompts[1], "max_new_tokens": 6,
                          "stream": True})
    assert code == 200
    assert [t for c in chunks[:-1] for t in c["tokens"]] == want[1]
    assert set(chunks[-1]) == _DONE_KEYS and chunks[-1]["done"] is True
    assert chunks[-1]["n_tokens"] == 6


def test_long_prompts_go_through_chunks(served_chunked):
    """Concurrent blocking requests, two of them longer than the chunk:
    the JAX engine's tokens, and the reference trailer's chunk counts
    (4 and 3 chunks; the short prompt rides a wave)."""
    url, prompts, want, chunks = served_chunked
    assert chunks == [4, 0, 3]
    results = {}

    def one(i):
        results[i] = _post(f"{url}/generate",
                           {"tokens": prompts[i], "max_new_tokens": 6})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    for i in range(len(prompts)):
        code, out = results[i]
        assert code == 200 and set(out) == _BLOCKING_KEYS
        assert out["tokens"] == want[i]
        assert out["prefill_chunks"] == chunks[i]


def test_long_prompt_streams_through_chunks(served_chunked):
    url, prompts, want, _ = served_chunked
    code, lines = _post(f"{url}/generate",
                        {"tokens": prompts[0], "max_new_tokens": 6,
                         "stream": True})
    assert code == 200
    assert [t for c in lines[:-1] for t in c["tokens"]] == want[0]
    assert set(lines[-1]) == _DONE_KEYS and lines[-1]["n_tokens"] == 6


@pytest.mark.parametrize("stream", [False, True], ids=["blocking",
                                                       "stream"])
def test_oversize_prompt_gets_the_reference_typed_400(served, stream):
    url, _, _ = served
    code, out = _post(f"{url}/generate",
                      {"tokens": list(range(1, 41)), "stream": stream})
    assert code == 400
    assert out == {"error": je.PromptTooLongError(40, 32).typed_error}


def test_bad_requests(served):
    url, _, _ = served
    code, out = _post(f"{url}/generate", {"max_new_tokens": 3})
    assert code == 400 and "bad request" in out["error"]
    code, _ = _post(f"{url}/nope", {"tokens": [1]})
    assert code == 404


@pytest.mark.parametrize("stream", [False, True], ids=["blocking",
                                                       "stream"])
def test_handoff_routes_answer_typed_errors(served_chunked, stream):
    """``/prefill`` on a request that cannot hand off (here: no prefix
    cache) gets the reference's typed 409, which the load balancer
    answers by serving the request single-tier; ``/handoff`` with a
    malformed export gets a 400 before any bytes stream; a handoff with
    no export resumes cold after its committed token, which streams
    first; an unknown path is a 404 (``/drain`` is a route now: see
    ``test_drain_lifecycle``)."""
    url, prompts, want, _ = served_chunked
    code, out = _post(f"{url}/prefill", {"tokens": prompts[0],
                                         "max_new_tokens": 6})
    assert code == 409 and out["error"]["type"] == "handoff_ineligible"
    bad = {"tensors": {"k": {"shape": [2], "dtype": "float32",
                             "data": "!!"}}}
    code, out = _post(f"{url}/handoff", {
        "tokens": prompts[0], "committed": want[0][:1], "export": bad,
        "max_new_tokens": 6, "stream": stream})
    assert code == 400 and "bad handoff" in out["error"]
    code, out = _post(f"{url}/handoff", {
        "tokens": prompts[0], "committed": want[0][:1],
        "max_new_tokens": 6, "stream": stream})
    assert code == 200
    if stream:
        assert out[0]["tokens"] == want[0][:1]
        assert out[-1]["done"] and out[-1]["n_tokens"] == 6
        out = {"tokens": [t for c in out for t in c.get("tokens", [])]}
    assert out["tokens"] == want[0]
    code, _ = _post(f"{url}/nope", {"tokens": [1]})
    assert code == 404


def test_main_serves_on_the_cpu():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "skypilot_tpu_torch.infer.server",
         "--config", "llama3-tiny", "--device", "cpu", "--port",
         str(port), "--slots", "2", "--max-len", "64", "--kv-block",
         "16"], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=5) as r:
                    if json.loads(r.read())["status"] == "ok":
                        break
            except (urllib.error.URLError, ConnectionError):
                pass
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.time() < deadline, "server never became healthy"
            time.sleep(0.2)
        code, out = _post(f"http://127.0.0.1:{port}/generate",
                          {"tokens": [3, 17, 42], "max_new_tokens": 4})
        assert code == 200 and len(out["tokens"]) == 4
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# -- the reference server's defaults: prefix cache and speculation ----------

_TRAILER = ("tokens", "cache_hit", "cached_tokens", "prefill_chunks",
            "spec_drafted", "spec_accepted", "drafter")
# A 20-token shared prefix with two tails (27 and 23 tokens): chunks of
# 8 and blocks of 16 store the first prompt's 24-token prefix (a partial
# block, copied on share) and hit 16 of it, one whole block, for the
# second. The shared
# prefix repeats a span so the n-gram drafter finds matches.
_SHARED = [7, 3, 9, 4, 8, 2, 7, 3, 9, 4, 8, 2, 7, 3, 9, 4, 11, 12, 13, 14]
_PAIR = (_SHARED + [21, 22, 23, 24, 25, 26, 27], _SHARED + [31, 32, 33])
_SPEC_KW = dict(n_slots=2, max_len=64, prompt_buckets=(16, 32),
                kv_block=16, prefill_chunk=8, prefix_pool=2, spec_k=4)


def _pair_trailers(submit):
    return [{k: out[k] for k in _TRAILER}
            for out in (submit(p, 12) for p in _PAIR)]


@pytest.fixture(scope="module")
def jax_pair_trailers():
    """The pair, one after the other, through the JAX ModelServer (open
    window pinned, so every plain burst is open_burst long)."""
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    jp = jl.init_params(jax.random.key(0), jcfg)
    model = js.ModelServer(je.InferenceEngine(jp, jcfg, kv_kernel=True,
                                              **_SPEC_KW),
                           open_window_s=600.0)
    try:
        return _pair_trailers(model.submit)
    finally:
        model.shutdown()


@pytest.mark.parametrize("stream", [False, True], ids=["blocking",
                                                       "stream"])
def test_shared_prefix_pair_reports_the_reference_trailer(
        jax_pair_trailers, stream):
    """Through the port's HTTP server with prefix_pool 2 and spec_k 4:
    the pair's tokens and trailer values (cache_hit, cached_tokens,
    prefill_chunks, spec_drafted, spec_accepted, drafter) equal the JAX
    server's; the streamed closing line carries the same values."""
    jcfg = dataclasses.replace(jl.CONFIGS["llama3-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    tp = tl.params_from_numpy(
        jax.tree.map(np.asarray, jl.init_params(jax.random.key(0), jcfg)),
        tcfg, device="cpu")
    engine = te.InferenceEngine(tp, tcfg, device="cpu", **_SPEC_KW)
    port = _free_port()
    model, httpd = ts.serve(engine, host="127.0.0.1", port=port,
                            open_window_s=600.0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        model.wait_ready(timeout=120)
        assert not model._async_decode

        def submit(tokens, max_new):
            code, out = _post(f"http://127.0.0.1:{port}/generate",
                              {"tokens": tokens, "max_new_tokens": max_new,
                               "stream": stream})
            assert code == 200
            if not stream:
                return out
            done = dict(out[-1])
            assert set(done) == _DONE_KEYS
            done["tokens"] = [x for c in out[:-1] for x in c["tokens"]]
            done["prefill_chunks"] = jax_pair_trailers[
                len(seen)]["prefill_chunks"]      # not on the done line
            seen.append(done)
            return done

        seen = []
        got = _pair_trailers(submit)
    finally:
        httpd.shutdown()
        model.shutdown()
        t.join(timeout=30)
    assert got == jax_pair_trailers
    first, second = got
    assert (first["cache_hit"], first["prefill_chunks"]) == (False, 4)
    assert (second["cache_hit"], second["cached_tokens"],
            second["prefill_chunks"]) == (True, 16, 1)
    assert first["spec_drafted"] + second["spec_drafted"] > 0
    assert {first["drafter"], second["drafter"]} <= {"ngram", "off"}
    assert engine.cow_copies == 1 and engine.prefix_hits == 1


def test_speculative_engine_runs_the_synchronous_path(monkeypatch):
    """A spec engine's server never double-buffers: it decodes through
    decode_burst (the verify round, or a plain burst fetched at once),
    never dispatching a burst of its own."""
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    params = tl.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    engine = te.InferenceEngine(params, tcfg, device="cpu", **_SPEC_KW)

    inside = []
    real_dispatch, real_decode = (engine.dispatch_decode_burst,
                                  engine.decode_burst)

    def decode_burst(*a, **kw):
        inside.append(True)
        try:
            return real_decode(*a, **kw)
        finally:
            inside.pop()

    def dispatch(*a, **kw):
        assert inside, "the server dispatched a burst of its own"
        return real_dispatch(*a, **kw)

    monkeypatch.setattr(engine, "decode_burst", decode_burst)
    monkeypatch.setattr(engine, "dispatch_decode_burst", dispatch)
    spec_rounds = []
    real = engine.spec_decode_burst
    monkeypatch.setattr(engine, "spec_decode_burst",
                        lambda: spec_rounds.append(1) or real())
    model = ts.ModelServer(engine)
    try:
        model.wait_ready(timeout=120)
        out = model.submit(_PAIR[1], 8)
    finally:
        model.shutdown()
    assert len(out["tokens"]) == 8 and spec_rounds


@pytest.mark.parametrize("env,want", [
    ({}, (8, 4)), ({"SKYTPU_PREFIX_POOL": "3", "SKYTPU_SPEC_K": "0"},
                   (3, 0))], ids=["defaults", "env"])
def test_main_defaults_prefix_pool_and_spec_k(monkeypatch, env, want):
    """``main`` passes the reference server's defaults, prefix pool 8 and
    spec K 4, to the engine; SKYTPU_PREFIX_POOL / SKYTPU_SPEC_K override
    them, and the flags override the environment."""
    seen = []

    class Stop(Exception):
        pass

    def fake_make_engine(config, **kw):
        seen.append((kw["prefix_pool"], kw["spec_k"]))
        raise Stop

    monkeypatch.delenv("SKYTPU_PREFIX_POOL", raising=False)
    monkeypatch.delenv("SKYTPU_SPEC_K", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(ts, "make_engine", fake_make_engine)
    with pytest.raises(Stop):
        ts.main(["--config", "llama3-tiny", "--device", "cpu"])
    with pytest.raises(Stop):
        ts.main(["--config", "llama3-tiny", "--device", "cpu",
                 "--prefix-pool", "5", "--spec-k", "2"])
    assert seen == [want, (5, 2)]


# -- the fleet path and the repo's w8a8 recipe line ---------------------------

def _unchunk(body: bytes) -> bytes:
    """Decode a chunked transfer-encoded body."""
    out, pos = b"", 0
    while True:
        eol = body.index(b"\r\n", pos)
        size = int(body[pos:eol].split(b";")[0], 16)
        if size == 0:
            return out
        out += body[eol + 2:eol + 2 + size]
        pos = eol + 2 + size + 2


def _streamed_tokens(body: bytes):
    lines = [json.loads(x) for x in _unchunk(body).splitlines() if x.strip()]
    return [t for c in lines for t in c.get("tokens", [])]


def test_client_wave_through_the_reference_lb_equals_direct(
        served, tmp_path, monkeypatch):
    """A port server behind the JAX package's own load balancer, wired as
    the reference bench wires its replica
    (``skypilot_tpu/infer/bench_serve.py::run_http``): the port's bench
    client gets the same ``n_tokens`` and the same streamed tokens (the
    JAX engine's) through the LB as straight from the server. This is
    the fleet path that the port's ``run_http`` leaves out."""
    from skypilot_tpu.serve import load_balancer, serve_state
    from skypilot_tpu_torch.infer import bench_serve as tb
    monkeypatch.setenv("SKYPILOT_TPU_HOME", str(tmp_path / "home"))
    url, prompts, want = served
    model_port = int(url.rsplit(":", 1)[1])
    lb_port = _free_port()
    serve_state.add_service("bench", {}, {}, lb_port)
    serve_state.upsert_replica("bench", 1, "bench-replica",
                               serve_state.ReplicaStatus.READY, url)
    lb = load_balancer._ThreadingServer(
        ("127.0.0.1", lb_port),
        load_balancer.make_handler("bench",
                                   load_balancer.LeastLoadPolicy()))
    t = threading.Thread(target=lb.serve_forever, daemon=True)
    t.start()
    payloads = [json.dumps({"tokens": p, "max_new_tokens": 6,
                            "stream": True}).encode() for p in prompts]
    try:
        direct_bodies, lb_bodies = [], []
        direct = tb._client_wave("127.0.0.1", model_port, payloads,
                                 timeout=120, bodies=direct_bodies)
        via_lb = tb._client_wave("127.0.0.1", lb_port, payloads,
                                 timeout=120, bodies=lb_bodies)
    finally:
        lb.shutdown()
        lb.server_close()
        t.join(timeout=30)
    assert [n for _, n, _ in via_lb] == [n for _, n, _ in direct] == [6] * 3
    assert [_streamed_tokens(b) for b in lb_bodies] == \
        [_streamed_tokens(b) for b in direct_bodies] == want


def _recipe_argv():
    """The run line of ``llm/serve-8b-w8a8.yaml`` with the port's server
    in place of the reference's."""
    import shlex

    import yaml
    with open(os.path.join(ROOT, "llm", "serve-8b-w8a8.yaml")) as f:
        # The shell drops each backslash-newline line continuation.
        argv = shlex.split(yaml.safe_load(f)["run"].replace("\\\n", " "))
    mod = argv.index("-m") + 1
    assert argv[mod] == "skypilot_tpu.infer.server"
    return argv[mod + 1:]


@pytest.mark.parametrize("argv,want", [
    (None, (4, 1.0, 0.012)),
    (["--config", "llama3-tiny", "--device", "cpu", "--slots", "32",
      "--max-len", "1280", "--weights-int8", "--kv-int8", "--max-burst",
      "32", "--open-burst", "4", "--admit-wave", "4"], (4, 1.0, 0.012)),
    (["--config", "llama3-tiny", "--device", "cpu", "--open-burst", "2",
      "--open-window", "2.5", "--coalesce", "0.02"], (2, 2.5, 0.02))],
    ids=["recipe", "recipe_flags", "explicit"])
def test_main_takes_the_w8a8_recipe_line(monkeypatch, argv, want):
    """``main`` parses the repo's w8a8 recipe command line as it stands
    (``--open-burst`` included) and hands ``--open-burst``,
    ``--open-window`` and ``--coalesce`` to ``serve()`` (engine build
    stubbed)."""
    made, served_kw = [], []

    class Stop(Exception):
        pass

    def fake_make_engine(config, **kw):
        made.append(dict(kw, config=config))
        return object()

    def fake_serve(engine, **kw):
        served_kw.append(kw)
        raise Stop

    monkeypatch.setattr(ts, "make_engine", fake_make_engine)
    monkeypatch.setattr(ts, "serve", fake_serve)
    recipe = argv is None
    with pytest.raises(Stop):
        ts.main(_recipe_argv() if recipe else argv)
    kw = served_kw[0]
    assert (kw["open_burst"], kw["open_window_s"], kw["coalesce_s"]) == want
    if argv is None or "--weights-int8" in argv:
        assert kw["max_burst"] == 32
        assert {k: made[0][k] for k in ("slots", "max_len", "admit_wave",
                                        "kv_int8", "weights_int8")} == {
            "slots": 32, "max_len": 1280, "admit_wave": 4,
            "kv_int8": True, "weights_int8": True}
    if recipe:
        assert made[0]["config"] == "llama3-8b" and kw["port"] == 8080


# -- the operator surface: drain, health, metrics, typed sheds ----------------

@pytest.fixture(scope="module")
def tiny():
    tcfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                               dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    return tcfg, tl.init_params(tcfg, gen, device="cpu",
                                dtype=torch.float32)


class _SlowEngine(te.InferenceEngine):
    """A port engine whose decode bursts take ``delay_s`` more, so that
    requests stay in flight while a test walks a drain around them."""

    delay_s = 0.02

    def dispatch_decode_burst(self, max_burst: int = 8):
        time.sleep(self.delay_s)
        return super().dispatch_decode_burst(max_burst)


def _port_replica(tiny, engine_cls=te.InferenceEngine, qos=None,
                  sched=None, **kw):
    tcfg, tp = tiny
    engine = engine_cls(tp, tcfg, n_slots=2, max_len=64,
                        prompt_buckets=(16,), kv_block=16, device="cpu",
                        qos=sched)
    port = _free_port()
    model, httpd = ts.serve(engine, host="127.0.0.1", port=port, qos=qos,
                            **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    model.wait_ready(timeout=120)
    return model, httpd, f"http://127.0.0.1:{port}"


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_drain_lifecycle(tiny):
    """``tests/test_serve_recovery.py::test_drain_lifecycle`` against a
    port replica: healthy; a malformed drain body is a typed 400 that
    leaves the state alone; drain requested with a request in flight;
    admissions shed with the typed 503 on a keep-alive connection that
    stays parseable; /health 503 draining with Retry-After and /healthz
    draining; the in-flight request finishes; /drain polls to drained
    with its first deadline."""
    import http.client
    from urllib.parse import urlsplit
    model, httpd, url = _port_replica(tiny, _SlowEngine, max_burst=1)
    try:
        code, body, _ = _get(f"{url}/healthz")
        assert code == 200 and json.loads(body)["status"] == "healthy"
        code, out = _post(f"{url}/drain", [1, 2])
        assert code == 400 and not model.draining()
        result = {}

        def client():
            result["resp"] = _post(f"{url}/generate",
                                   {"tokens": [1, 2], "max_new_tokens": 40})

        t = threading.Thread(target=client)
        t.start()
        deadline = time.time() + 30
        while model.queue_depth() == 0 and time.time() < deadline:
            time.sleep(0.005)
        assert model.queue_depth() > 0
        code, st = _post(f"{url}/drain", {"grace_s": 20})
        assert code == 200 and st["draining"] and not st["drained"]
        assert st["in_flight"] >= 1
        deadline_s = st["deadline_s"]
        parts = urlsplit(url)
        conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                          timeout=30)
        conn.request("POST", "/generate", body=json.dumps(
            {"tokens": [3], "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 503 and r.getheader("Retry-After") == "1"
        assert json.loads(r.read())["error"]["type"] == "draining"
        conn.request("GET", "/healthz")
        hz = json.loads(conn.getresponse().read())
        assert hz["status"] == "draining" and "in flight" in hz["reason"]
        conn.close()
        code, body, hdrs = _get(f"{url}/health")
        assert code == 503 and hdrs["Retry-After"] == "1"
        assert json.loads(body)["status"] == "draining"
        t.join(timeout=60)
        code, out = result["resp"]
        assert code == 200 and len(out["tokens"]) == 40
        deadline = time.time() + 30
        st = model.drain_status()
        while not st["drained"] and time.time() < deadline:
            time.sleep(0.02)
            code, st = _post(f"{url}/drain", {"grace_s": 20})
        assert st["drained"] and st["in_flight"] == 0
        assert st["deadline_s"] == deadline_s
    finally:
        model.shutdown()
        httpd.shutdown()


def test_drain_past_deadline_degrades_healthz(tiny):
    """A drain that cannot finish inside its grace window reports
    degraded on /healthz (``tests/test_serve_recovery.py:464``)."""
    model, httpd, url = _port_replica(tiny, _SlowEngine, max_burst=1)
    try:
        p = model._add([1], 10 ** 6)        # runs to max_len
        deadline = time.time() + 30
        while model.queue_depth() == 0 and time.time() < deadline:
            time.sleep(0.005)
        code, st = _post(f"{url}/drain", {"grace_s": 0})
        assert code == 200 and st["draining"]
        time.sleep(0.05)
        code, body, _ = _get(f"{url}/healthz")
        hz = json.loads(body)
        assert hz["status"] == "degraded" and "past deadline" in hz["reason"]
        assert p.event.wait(timeout=60)
    finally:
        model.shutdown()
        httpd.shutdown()


def test_reference_controller_drains_a_port_replica(tiny, tmp_path,
                                                    monkeypatch):
    """The reference replica manager's drain poll
    (``serve/replica_managers.py::ReplicaManager._drain_replica``)
    drains a port replica with a request in flight: it returns True once
    the request finished, and the replica then sheds."""
    from skypilot_tpu.serve import replica_managers, serve_state
    from skypilot_tpu.serve.service_spec import SkyServiceSpec
    monkeypatch.setenv("SKYPILOT_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SKYTPU_SERVE_DRAIN_GRACE_S", "30")
    serve_state.add_service("portsvc", {}, {}, 0)
    mgr = replica_managers.ReplicaManager("portsvc", SkyServiceSpec(), {})
    model, httpd, url = _port_replica(tiny, _SlowEngine, max_burst=1)
    try:
        p = model._add([1, 2], 30)
        deadline = time.time() + 30
        while model.queue_depth() == 0 and time.time() < deadline:
            time.sleep(0.005)
        assert mgr._drain_replica(url) is True
        assert p.event.is_set() and len(p.result["tokens"]) == 30
        code, out = _post(f"{url}/generate", {"tokens": [1]})
        assert code == 503 and out["error"]["type"] == "draining"
    finally:
        model.shutdown()
        httpd.shutdown()
        mgr._pool.shutdown(wait=False)


def test_metrics_parse_under_the_reference_names(tiny):
    """``GET /metrics`` parses with the reference's ``parse_exposition``;
    every family the port declares is one of the reference registry's,
    with its type, labels and help; TTFT, the QoS shed counter and the
    draining gauge are present; and the TTFT count grows by the requests
    answered (the warmup records nothing)."""
    from skypilot_tpu.infer import server as js_
    from skypilot_tpu.observability import goodput as jg_
    from skypilot_tpu.observability import metrics as jm
    from skypilot_tpu.train import checkpoints as jc_
    from skypilot_tpu.train import trainer as jt_
    from skypilot_tpu_torch.observability import metrics as tm
    # Registers the reference's families: the server's, and those of the
    # train modules whose port counterparts may share this process.
    del js_, jg_, jc_, jt_
    model, httpd, url = _port_replica(tiny)
    try:
        def ttft_count():
            code, body, hdrs = _get(f"{url}/metrics")
            assert code == 200
            assert hdrs["Content-Type"] == jm.CONTENT_TYPE
            fams = jm.parse_exposition(body.decode())
            for name in ("skytpu_ttft_seconds", "skytpu_qos_shed_total",
                         "skytpu_server_draining"):
                assert name in fams, name
            return fams, sum(v for lab, v in
                             fams["skytpu_ttft_seconds"]["samples"]
                             if lab.get("__name__") ==
                             "skytpu_ttft_seconds_count")

        fams, n0 = ttft_count()
        for i in range(2):
            assert _post(f"{url}/generate", {"tokens": [1, 2 + i],
                                             "max_new_tokens": 3})[0] == 200
        fams, n1 = ttft_count()
        assert n1 - n0 == 2
        ref = jm.REGISTRY.snapshot()
        for name, fam in tm.REGISTRY.snapshot().items():
            assert name in ref, name
            have = jm.REGISTRY.get(name)
            mine = tm.REGISTRY.get(name)
            assert (mine.type, mine.labelnames, mine.help) == \
                (have.type, have.labelnames, have.help), name
            assert getattr(mine, "buckets", None) == \
                getattr(have, "buckets", None), name
        assert set(fams) <= set(ref)
    finally:
        model.shutdown()
        httpd.shutdown()


class _FakeEngine:
    """A reference-server engine double (``tests/test_qos.py``): instant
    admission, one token per burst; its KV-quota check is a JAX engine's
    (built, never run) and it cannot hand off."""

    def __init__(self, quota_engine, n_slots=4):
        self.n_slots = n_slots
        self.waiting, self.slot_req, self.finished = [], {}, []
        self.free_slots = list(range(n_slots))
        self.buckets = (16,)
        self._rid = 0
        self.check_kv_quota = quota_engine.check_kv_quota

    def handoff_eligible(self, tokens, max_new):
        return False

    def add_request(self, tokens, max_new, **kw):
        r = je.Request(rid=self._rid, prompt=list(tokens),
                       max_new_tokens=max_new)
        self._rid += 1
        self.waiting.append(r)
        return r.rid

    def admit(self, on_wave=None):
        while self.waiting and self.free_slots:
            r = self.waiting.pop(0)
            r.slot = self.free_slots.pop(0)
            r.tokens.append(7)
            r.first_token_s = time.time()
            self.slot_req[r.slot] = r

    def decode_burst(self, max_burst=8):
        for slot, r in list(self.slot_req.items()):
            r.tokens.append(8)
            if len(r.tokens) >= r.max_new_tokens:
                self.slot_req.pop(slot)
                self.free_slots.append(slot)
                self.finished.append(r)
        return {}

    def generate(self, prompts, max_new_tokens=2):
        return [[1] * max_new_tokens for _ in prompts]

    def reset(self):
        self.waiting.clear()
        self.slot_req.clear()
        self.free_slots = list(range(self.n_slots))


def _raw(url, path, body: bytes, headers):
    import http.client
    from urllib.parse import urlsplit
    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=60)
    try:
        conn.request("POST", path, body=body, headers=headers)
        r = conn.getresponse()
        return r.status, json.loads(r.read()), r.getheader("Retry-After")
    finally:
        conn.close()


def test_typed_errors_equal_the_reference_servers(tiny):
    """The same requests against a port replica and the reference server,
    each with ``AdmissionController`` rate 0.001/s, burst 1: a tenant's
    second request is the typed 429 with ``Retry-After``; a tenant whose
    ``max_kv_blocks`` cannot hold the request gets the 400
    ``kv_quota_unsatisfiable`` body; ``/prefill`` of an ineligible
    request the 409; a chunked body the 411; a queue past
    ``max_waiting`` the 503 ``overloaded``; a draining replica the 503
    ``draining`` with ``Retry-After: 1``. Bodies equal but for the 429's
    time-dependent ``retry_after_ms`` and message."""
    tcfg, tp = tiny
    jcfg = jl.CONFIGS["llama3-tiny"]
    servers = []
    for side in ("port", "ref"):
        mod = tq if side == "port" else jq
        qcfg = mod.QosConfig(enabled=True, default_rate=0.001,
                             default_burst=1.0, max_waiting=50,
                             tenants={"hog": mod.TenantSpec(
                                 rate=1000.0, max_kv_blocks=1)})
        ac = mod.AdmissionController(qcfg, where="server")
        if side == "port":
            model, httpd, url = _port_replica(
                tiny, qos=ac, sched=tq.FairScheduler(qcfg))
        else:
            quota = je.InferenceEngine(
                jl.init_params(jax.random.key(0), jcfg), jcfg, n_slots=2,
                max_len=64, prompt_buckets=(16,), kv_block=16,
                prefix_pool=0, qos=jq.FairScheduler(qcfg))
            model = js.ModelServer(_FakeEngine(quota), qos=ac)
            port = _free_port()
            httpd = js._Threading(("127.0.0.1", port),
                                  js.make_handler(model))
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
            url = f"http://127.0.0.1:{port}"
            assert model._ready.wait(timeout=60)
        servers.append((model, httpd, url, ac))
    got = []
    try:
        for model, httpd, url, ac in servers:
            seen = []
            js_hdr = {"Content-Type": "application/json"}

            def post(path, payload, tenant):
                return _raw(url, path, json.dumps(payload).encode(),
                            dict(js_hdr, **{"x-skytpu-tenant": tenant}))

            gen = {"tokens": [1, 2], "max_new_tokens": 3}
            code, out, _ = post("/generate", gen, "hot")
            seen.append(code)
            code, out, ra = post("/generate", gen, "hot")
            err = dict(out["error"])
            assert err.pop("retry_after_ms") > 0 and int(ra) >= 1
            err.pop("message")
            seen.append((code, err))
            seen.append(post("/generate", {"tokens": [1, 2, 3],
                                           "max_new_tokens": 60}, "hog"))
            seen.append(post("/prefill", gen, "p1"))
            seen.append(_raw(url, "/generate", b"2\r\n{}\r\n0\r\n\r\n",
                             dict(js_hdr, **{"Transfer-Encoding":
                                             "chunked"})))
            ac.cfg.max_waiting = 1
            model._pending[10_000] = object()       # a backlog
            try:
                seen.append(post("/generate", gen, "bg"))
            finally:
                model._pending.pop(10_000, None)
            model.start_drain(5.0)
            seen.append(post("/generate", gen, "late"))
            got.append(seen)
    finally:
        for model, httpd, _, _ in servers:
            httpd.shutdown()
            model.shutdown()
    assert got[0] == got[1]
    assert [x if isinstance(x, int) else x[0] for x in got[0]] == \
        [200, 429, 400, 409, 411, 503, 503]
    assert got[0][2][1]["error"]["type"] == "kv_quota_unsatisfiable"
    assert got[0][5][2] == "1" and got[0][6][2] == "1"


@pytest.mark.parametrize("argv,want", [
    ([], dict(temperature=0.0, kv_blocks=0, span_buckets=None,
              kv_lazy=None)),
    (["--temperature", "0.7", "--kv-blocks", "40", "--span-buckets",
      "16,32", "--kv-lazy"], dict(temperature=0.7, kv_blocks=40,
                                  span_buckets=[16, 32], kv_lazy=True)),
    (["--span-buckets", "0"], dict(temperature=0.0, kv_blocks=0,
                                   span_buckets=0, kv_lazy=None))],
    ids=["defaults", "flags", "spans_off"])
def test_main_takes_the_control_flags(monkeypatch, argv, want):
    """``main`` parses ``--temperature``, ``--kv-blocks``,
    ``--span-buckets`` (``0`` = off, a comma ladder) and ``--kv-lazy``
    with the reference's defaults, hands them to the engine, and builds
    the engine's fair scheduler and the server's admission controller
    from ``SKYTPU_QOS``."""
    made, served_kw = [], []

    class Stop(Exception):
        pass

    def fake_make_engine(config, **kw):
        made.append(kw)
        return object()

    def fake_serve(engine, **kw):
        served_kw.append(kw)
        raise Stop

    for k in ("SKYTPU_KV_BLOCKS", "SKYTPU_SPAN_BUCKETS", "SKYTPU_KV_LAZY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SKYTPU_QOS", "1")
    monkeypatch.setattr(ts, "make_engine", fake_make_engine)
    monkeypatch.setattr(ts, "serve", fake_serve)
    with pytest.raises(Stop):
        ts.main(["--config", "llama3-tiny", "--device", "cpu"] + argv)
    assert {k: made[0][k] for k in want} == want
    assert isinstance(made[0]["qos"], tq.FairScheduler)
    assert isinstance(served_kw[0]["qos"], tq.AdmissionController)


# -- the model drafter ----------------------------------------------------------

def _parser_of(main, monkeypatch):
    """The actions of the ``argparse`` parser that ``main()`` builds
    (captured at its ``parse_args``, which then stops it), by dest."""
    import argparse
    seen = []

    class Stop(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(sys, "argv", ["server", "--config", "llama3-tiny"])
    with pytest.raises(Stop):
        main()
    monkeypatch.undo()
    (parser,) = seen
    return {a.dest: a for a in parser._actions}


@pytest.mark.parametrize("argv,env,want", [
    ([], {}, dict(draft_model=None, spec_pipeline=None)),
    (["--draft-model", "self:1", "--spec-pipeline", "0"], {},
     dict(draft_model="self:1", spec_pipeline=False)),
    (["--draft-model", "llama3-400m", "--spec-pipeline", "1"],
     {"SKYTPU_DRAFT_MODEL": "self:2"},
     dict(draft_model="llama3-400m", spec_pipeline=True))],
    ids=["defaults", "self_sync", "config_pipelined"])
def test_main_takes_the_draft_flags(monkeypatch, argv, env, want):
    """``main`` declares ``--draft-model`` and ``--spec-pipeline`` with
    the reference server's defaults, types and help, and hands them to
    the engine's builder (None each: the environment decides, in
    ``draft_engine_from_env`` and the engine)."""
    from skypilot_tpu.infer import server as js_
    mine = _parser_of(ts.main, monkeypatch)
    ref = _parser_of(js_.main, monkeypatch)
    for dest in ("draft_model", "spec_pipeline"):
        assert (mine[dest].option_strings, mine[dest].default,
                mine[dest].type, mine[dest].help) == \
            (ref[dest].option_strings, ref[dest].default, ref[dest].type,
             ref[dest].help), dest
    made = []

    class Stop(Exception):
        pass

    def fake_make_engine(config, **kw):
        made.append(kw)
        raise Stop

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(ts, "make_engine", fake_make_engine)
    with pytest.raises(Stop):
        ts.main(["--config", "llama3-tiny", "--device", "cpu"] + argv)
    assert {k: made[0][k] for k in want} == want


def test_make_engine_builds_the_drafter(monkeypatch):
    """``make_engine``'s drafter: ``self:N`` shares the target's blocks
    (views) unless w8a8 drops the float tree, where its N layers are
    copies; a config name gets the target's vocabulary; the draft pool
    is int8 under ``kv_int8``; SKYTPU_DRAFT_MODEL stands in for the
    argument."""
    kw = dict(slots=2, max_len=64, device="cpu", prefill_chunk=0,
              prefix_pool=0)
    e = ts.make_engine("llama3-tiny", draft_model="self:1", **kw)
    de = e.draft_engine
    assert de.cfg.n_layers == 1 and de.n_slots == 2 and e.spec_pipeline
    assert de.params["blocks"]["wq"].data_ptr() == \
        e.params["blocks"]["wq"].data_ptr()
    e = ts.make_engine("llama3-tiny", draft_model="self:1",
                       weights_int8=True, kv_int8=True,
                       spec_pipeline=False, **kw)
    de = e.draft_engine
    assert "wq" not in e.params.get("blocks", {})
    assert de.params["blocks"]["wq"]._base is None
    assert de.cache["k"].dtype == torch.int8 and not e.spec_pipeline
    monkeypatch.setenv("SKYTPU_DRAFT_MODEL", "llama3-tiny")
    de = ts.make_engine("llama3-tiny", **kw).draft_engine
    assert de.cfg.n_layers == 2 and de.cfg.vocab_size == 512
    monkeypatch.delenv("SKYTPU_DRAFT_MODEL")
    assert ts.make_engine("llama3-tiny", **kw).draft_engine is None


def test_trailer_reads_drafter_model():
    """A replica drafting with ``self:2`` (the whole tiny target, so
    acceptance holds and no request demotes): blocking and streamed
    trailers say ``drafter: model`` with drafted tokens, and ``/metrics``
    counts them under ``skytpu_spec_draft_tokens_total{drafter="model"}``
    and the pipeline's wall counters."""
    from skypilot_tpu.observability import metrics as jm
    engine = ts.make_engine("llama3-tiny", slots=2, max_len=64,
                            device="cpu", prefill_chunk=0, prefix_pool=0,
                            draft_model="self:2", spec_pipeline=True)
    port = _free_port()
    model, httpd = ts.serve(engine, host="127.0.0.1", port=port)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{port}"
    try:
        model.wait_ready(timeout=120)

        def drafted():
            code, body, _ = _get(f"{url}/metrics")
            assert code == 200
            fams = jm.parse_exposition(body.decode())
            return {n: sum(v for lab, v in fams[n]["samples"]
                           if lab.get("drafter", "model") == "model")
                    for n in ("skytpu_spec_draft_tokens_total",
                              "skytpu_spec_verify_wall_seconds_total",
                              "skytpu_spec_overlap_wall_seconds_total")
                    if n in fams}

        before = drafted()
        code, out = _post(f"{url}/generate", {"tokens": [5, 9, 2, 6],
                                              "max_new_tokens": 12})
        assert code == 200 and out["drafter"] == "model"
        assert out["spec_drafted"] > 0 and len(out["tokens"]) == 12
        code, lines = _post(f"{url}/generate", {
            "tokens": [7, 1, 8, 2, 8], "max_new_tokens": 12,
            "stream": True})
        assert code == 200 and lines[-1]["done"]
        assert lines[-1]["drafter"] == "model"
        after = drafted()
        name = "skytpu_spec_draft_tokens_total"
        assert after[name] - before.get(name, 0.0) >= out["spec_drafted"]
        for name in ("skytpu_spec_verify_wall_seconds_total",
                     "skytpu_spec_overlap_wall_seconds_total"):
            assert after[name] > before.get(name, 0.0), name
    finally:
        model.shutdown()
        httpd.shutdown()
    assert engine.draft_engine.blocks_used == 0
