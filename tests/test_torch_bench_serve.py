"""The port's serving bench (``skypilot_tpu_torch/infer/bench_serve.py``)
on the CPU, against the JAX package's ``skypilot_tpu/infer/bench_serve.py``:
the smoke pass meets the reference's own guard and counts the same
chunks, hits and admission bursts, both draw the same prompts for seed
0, every report has the reference report's keys (anchor keys null, the
transport the port's), ``main`` prints one JSON line, the client raises
on a typed 400, and without a card the bench raises instead of running
on the CPU. The contiguous layout's sections (``run_occupancy``,
``run_span``, ``run_kernel``) meet the reference's guards at their smoke
sizes and ``main``'s ``--occupancy``/``--span``/``--kernel`` lines carry
the reference's keys."""

import ast
import json
import socket
import threading

import numpy as np
import pytest
import torch

from skypilot_tpu.infer import bench_serve as jb
from skypilot_tpu.infer import engine as je
from skypilot_tpu_torch.infer import bench_serve as tb
from skypilot_tpu_torch.infer import engine as te
from skypilot_tpu_torch.infer import server as ts
from skypilot_tpu_torch.models import llama as tl
from torch_bench_ref import (_ANCHOR_KEYS, _assigned_dict_keys, _dict_keys,
                             _ref_function, _returned_keys)

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)


def _record_prompts(engine_cls):
    """Patch ``engine_cls.add_request`` to log every prompt, in order."""
    seen = []
    real = engine_cls.add_request

    def add_request(self, prompt, *a, **kw):
        seen.append(list(prompt))
        return real(self, prompt, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(engine_cls, "add_request", add_request)
    return seen, mp


@pytest.fixture(scope="module")
def jax_smoke():
    """The JAX package's ``run_smoke()`` and every prompt it submitted."""
    seen, mp = _record_prompts(je.InferenceEngine)
    try:
        report = jb.run_smoke()
    finally:
        mp.undo()
    return report, seen


@pytest.fixture(scope="module")
def port_smoke():
    seen, mp = _record_prompts(te.InferenceEngine)
    try:
        report = tb.run_smoke(device="cpu")
    finally:
        mp.undo()
    return report, seen


def test_run_smoke_meets_the_reference_guard(port_smoke):
    """Every assertion of the reference's own guard,
    ``tests/test_prefix_cache.py::test_bench_serve_smoke_guard``."""
    r, _ = port_smoke
    assert r["parity_ok"]
    assert r["prefix_hits"] >= 1 and r["hit_rate"] > 0
    assert r["cold_hits"] == 0
    assert r["warm_chunks"] < r["cold_chunks"]
    assert r["warm_chunks"] == r["requests"]      # 1 suffix chunk each
    inter = r["interference"]
    # 2 long prompts x ceil(30/8)=4 chunks -> >= 8 alternation bursts.
    assert inter["admission_bursts"] >= 8
    assert inter["decode_stall_p99_ms"] > 0


# The structural (timing-free) numbers. The port's deliberate
# difference (ROADMAP.md: no wave padding) changes none of them: they
# count requests, chunks at the chunk size and prefix hits at chunk
# granularity, and the smoke pass pads no waves on either side.
@pytest.mark.parametrize("key", ["requests", "prefix_hits", "cold_hits",
                                 "hit_rate", "cold_chunks", "warm_chunks",
                                 "interference.admission_bursts"])
def test_run_smoke_counts_equal_the_jax_bench(port_smoke, jax_smoke, key):
    def get(r):
        for part in key.split("."):
            r = r[part]
        return r
    assert get(port_smoke[0]) == get(jax_smoke[0])


def test_run_prefix_share_submits_the_reference_prompts(port_smoke,
                                                        jax_smoke):
    """Warmup, both timed passes, the fillers and the long prompts of
    both interference runs: the same prompts, in the same order."""
    assert port_smoke[1] == jax_smoke[1]
    assert len(port_smoke[1]) > 4


def test_run_prefix_share_report_has_the_reference_keys(port_smoke,
                                                        jax_smoke):
    port, ref = port_smoke[0], jax_smoke[0]
    assert set(port) == set(ref) == _returned_keys("run_prefix_share")
    assert set(port["interference"]) == set(ref["interference"])


@pytest.mark.parametrize("lo,hi,requests", [(512, 1024, 16), (64, 900, 7)])
def test_mixed_prompts_equal_the_reference(lo, hi, requests):
    want = jb._mixed_prompts(np.random.default_rng(0), 128_256, requests,
                             lo, hi)
    got = tb._mixed_prompts(np.random.default_rng(0), 128_256, requests,
                            lo, hi)
    assert got == want


def test_run_report_has_the_reference_keys():
    r = tb.run(config="llama3-tiny", requests=4, slots=4, prompt_len=16,
               new_tokens=4, max_burst=4, device="cpu")
    assert set(r) == _returned_keys("run")
    assert r["vs_baseline_ttft"] is None
    assert r["median_ttft_ms"] > 0 and r["out_tok_s"] > 0


def test_run_http_report_has_the_reference_keys():
    """Mixed prompts (shrunk on the CPU as in the reference), two timed
    runs and the full-load phase."""
    r = tb.run_http(config="llama3-tiny", requests=4, slots=6,
                    new_tokens=4, max_burst=4, repeats=2, full_load=True,
                    device="cpu")
    assert set(r) == _returned_keys("run_http") | {"full_load"}
    assert set(r["full_load"]) == _assigned_dict_keys("run_http", "full")
    for k in _ANCHOR_KEYS:
        assert r[k] is None, k
    assert r["full_load"]["regressed"] is None
    assert r["transport"] == "http_streaming"
    assert len(r["runs"]) == 2
    assert r["prompt_max_len"] <= 1024 // 8
    assert r["median_ttft_ms"] > 0 and r["tpot_ms"] > 0


def _main_keys():
    """Keys of the reference ``main``'s JSON line for the headline and
    the prefix-share sections."""
    fn = _ref_function("main")
    dicts = [n for n in ast.walk(fn) if isinstance(n, ast.Dict)]
    head = next(d for d in dicts if "output_tok_per_s" in _dict_keys(d))
    prefix = next(d for d in dicts
                  if "serve_prefix_warm_ttft" in
                  {getattr(v, "value", None) for v in d.values})
    return _dict_keys(head), _dict_keys(prefix)


@pytest.mark.parametrize("mode", ["--engine-only", "http", "--smoke"])
def test_main_prints_one_json_line(capsys, mode):
    argv = ["--device", "cpu", "--config", "llama3-tiny", "--requests",
            "4", "--slots", "4", "--new-tokens", "4", "--max-burst", "4"]
    if mode != "http":
        argv.append(mode)
    tb.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    head, prefix = _main_keys()
    # The reference's keys, plus the device the numbers come from.
    if mode == "--smoke":
        assert set(out) == prefix | {"device"}
    elif mode == "http":
        assert set(out) == head | {"p99_ttft_ms", "transport", "device"}
        assert out["transport"] == "http_streaming"
    else:
        assert set(out) == head | {"device"}
    assert out["device"] == "cpu"
    assert out.get("vs_baseline") is None


def test_without_a_card_the_bench_raises(monkeypatch):
    """No CUDA card and no ``--device``: the bench raises instead of
    running the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main(["--engine-only", "--config", "llama3-tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.run_smoke()


@pytest.mark.parametrize("env,want", [
    ({}, (512, 0, 0)),
    ({"SKYTPU_PREFILL_CHUNK": "64", "SKYTPU_PREFIX_POOL": "2",
      "SKYTPU_SPEC_K": "3"}, (64, 2, 3))], ids=["defaults", "env"])
def test_build_engine_takes_the_reference_engine_defaults(monkeypatch, env,
                                                          want):
    """Chunks of 512, no prefix pool and no speculation unless the
    reference engine's environment knobs say otherwise; the kernel path
    (never the plain one); the reference's max_len, 96 + 64 + 8, in one
    block on the CPU as in the JAX engine."""
    for k in ("SKYTPU_PREFILL_CHUNK", "SKYTPU_PREFIX_POOL", "SKYTPU_SPEC_K"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg, e = tb._build_engine("llama3-tiny", 2, 96, 64, False, False,
                              device="cpu")
    assert (e.prefill_chunk, e.prefix_pool, e.spec_k) == want
    assert not e.plain_attention
    assert e.buckets == (96,) and e.max_len == 168 and e.kv_block == 168
    assert cfg is tl.CONFIGS["llama3-tiny"]


def test_build_engine_weights_int8_builds_no_float_blocks():
    _, e = tb._build_engine("llama3-tiny", 2, 16, 8, True, True,
                            device="cpu")
    assert e.qweights is not None and "k_scale" in e.cache
    assert not any(k in e.params["blocks"] for k in ("wq", "w_down"))
    assert len(e.generate([[3, 1, 4, 1, 5]], max_new_tokens=3)[0]) == 3


def test_client_wave_raises_on_a_typed_400():
    """A prompt longer than the engine's largest bucket gets the
    server's typed 400; the client counts it as a failure, never as a
    0-token success. A good request beside it returns its tokens."""
    params = tl.init_params(tl.CONFIGS["llama3-tiny"],
                            torch.Generator().manual_seed(0), device="cpu")
    engine = te.InferenceEngine(params, tl.CONFIGS["llama3-tiny"],
                                n_slots=2, max_len=64,
                                prompt_buckets=(16,), kv_block=16,
                                device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    model, httpd = ts.serve(engine, host="127.0.0.1", port=port,
                            max_burst=4)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        model.wait_ready(timeout=120)
        good = json.dumps({"tokens": [1, 2, 3], "max_new_tokens": 3,
                           "stream": True}).encode()
        res = tb._client_wave("127.0.0.1", port, [good], timeout=120)
        assert [n for _, n, _ in res] == [3]
        for stream in (True, False):
            bad = json.dumps({"tokens": list(range(1, 41)),
                              "max_new_tokens": 3,
                              "stream": stream}).encode()
            with pytest.raises(AssertionError, match="non-200.*400"):
                tb._client_wave("127.0.0.1", port, [good, bad],
                                timeout=120)
    finally:
        httpd.shutdown()
        httpd.server_close()
        model.shutdown()


# -- the contiguous layout's sections: occupancy, span, kernel ------------------

@pytest.fixture(scope="module")
def port_occupancy():
    """``run_occupancy(smoke=True)`` on llama3-tiny in float32 (the tiny
    config's bf16 puts near-ties everywhere, and K1's float32 value
    product parts from the gather's bf16-rounded weights at them), with
    the token lists behind its parity verdict."""
    import dataclasses
    real = tl.CONFIGS["llama3-tiny"]
    tl.CONFIGS["llama3-tiny"] = dataclasses.replace(real,
                                                    dtype=torch.float32)
    try:
        toks = {}
        r = tb.run_occupancy(smoke=True, device="cpu", tokens_out=toks)
    finally:
        tl.CONFIGS["llama3-tiny"] = real
    return r, toks


@pytest.fixture(scope="module")
def jax_occupancy():
    return jb.run_occupancy(smoke=True)


def test_run_occupancy_meets_the_reference_guard(port_occupancy):
    """The reference's keys, equal KV bytes on both layouts (trash rows
    counted on both), >= 4x the slots paged, no block leaked, and the
    paged engine's tokens equal to the contiguous one's."""
    r, toks = port_occupancy
    assert _returned_keys("run_occupancy") <= set(r)
    assert r["same_hbm"] and r["kv_hbm_bytes"] == r[
        "kv_hbm_bytes_contiguous"]
    assert r["parity_ok"] and r["leak_free"]
    assert r["occupancy_x"] >= 4 and not r["occupancy_regressed"]
    prompts, paged, contig = toks["parity"]
    assert len(prompts) == r["requests"] and paged == contig


@pytest.mark.parametrize("key", ["paged_slots", "contiguous_slots",
                                 "occupancy_x", "requests", "max_len",
                                 "new_tokens", "kv_block"])
def test_run_occupancy_counts_equal_the_jax_bench(port_occupancy,
                                                  jax_occupancy, key):
    assert port_occupancy[0][key] == jax_occupancy[key]


@pytest.fixture(scope="module")
def port_span():
    return tb.run_span_smoke(device="cpu")


def test_run_span_meets_the_reference_guard(port_span):
    """``tests/test_span_attn.py``'s guard on the smoke: the reference's
    keys, span-on tokens equal to the full view's, the span pass reading
    an eighth of the rows with one program per rung at most."""
    r = port_span
    assert _returned_keys("run_span") <= set(r)
    assert r["parity_ok"]
    assert r["rows_full"] == r["max_len"] == 2048
    assert r["rows_span"] == 256 and r["rows_ratio"] == 8.0
    assert 1 <= r["n_span_programs"] <= len(r["span_ladder"])


def test_run_kernel_meets_the_reference_guard():
    """The kernel bench's smoke: the reference's keys, kernel-on tokens
    equal to the plain route's, and both program keys dispatched."""
    r = tb.run_kernel_smoke(device="cpu")
    assert _assigned_dict_keys("run_kernel", "out") <= set(r)
    assert r["parity_ok"] and r["kernel_programs_ok"]
    assert r["backend"] == "cpu" and r["active_requests"] == 2


def _main_section_keys(metric):
    """Keys of the reference ``main``'s JSON line for ``metric``."""
    fn = _ref_function("main")
    for d in ast.walk(fn):
        if isinstance(d, ast.Dict) and metric in {
                getattr(v, "value", None) for v in d.values}:
            keys = _dict_keys(d)
            # ``**{k: r[k] for k in (...)}``: the tuple's names.
            for k, v in zip(d.keys, d.values):
                if k is None:
                    keys |= {e.value for e in v.generators[0].iter.elts}
            return keys
    raise AssertionError(metric)


@pytest.mark.parametrize("flag,metric", [
    ("--occupancy", "serve_occupancy_x"), ("--span", "serve_span_speedup"),
    ("--kernel", "serve_kernel_speedup")])
def test_main_prints_the_section_line(capsys, flag, metric):
    tb.main(["--device", "cpu", "--smoke", flag])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == metric
    assert set(out) == _main_section_keys(metric) | {"device"}
    assert out["device"] == "cpu"
