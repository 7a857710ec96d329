"""The port's HTTP server on the CPU: blocking and streamed /generate
return the JAX engine's greedy tokens, the response keys are the
reference server's, an oversize prompt gets the reference's typed 400
body, and prompts longer than the prefill chunk go through chunks, with
the reference trailer's ``prefill_chunks``."""

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
