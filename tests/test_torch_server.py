"""The port's HTTP server on the CPU: blocking and streamed /generate
return the JAX engine's greedy tokens, the response keys are the
reference server's, an oversize prompt gets the reference's typed 400
body, prompts longer than the prefill chunk go through chunks, with
the reference trailer's ``prefill_chunks``, and a shared-prefix pair
through a server with the prefix cache and speculation on reports the
JAX server's trailer values."""

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
from skypilot_tpu.infer import server as js
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import server as ts
from skypilot_tpu_torch.models import llama as tl

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
    first; other paths stay 404."""
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
    code, _ = _post(f"{url}/drain", {"tokens": [1]})
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
