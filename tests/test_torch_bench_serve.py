"""The port's serving bench (``skypilot_tpu_torch/infer/bench_serve.py``)
on the CPU, against the JAX package's ``skypilot_tpu/infer/bench_serve.py``:
the smoke pass meets the reference's own guard and counts the same
chunks, hits and admission bursts, both draw the same prompts for seed
0, every report has the reference report's keys (anchor keys null, the
transport the port's), ``main`` prints one JSON line, the client raises
on a typed 400, and without a card the bench raises instead of running
on the CPU."""

import ast
import json
import os
import pathlib
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SOURCE = pathlib.Path(ROOT, "skypilot_tpu", "infer", "bench_serve.py")

# Keys whose values compare with (or judge against) the reference's TPU
# anchor; the port reports them as null.
_ANCHOR_KEYS = ("vs_baseline_tpot", "vs_baseline_ttft",
                "worst_run_vs_baseline_ttft", "worst_run_below_1p2x",
                "regressed", "worst_run_regressed")


def _ref_function(name):
    tree = ast.parse(REF_SOURCE.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _dict_keys(node):
    """The constant keys of a dict literal (``**`` expansions skipped)."""
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _returned_keys(name):
    """Keys of the dict literal that the reference's ``name`` returns."""
    fn = _ref_function(name)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)
           and isinstance(n.value, ast.Dict)]
    assert len(ret) == 1, name
    return _dict_keys(ret[0].value)


def _assigned_dict_keys(fn_name, var):
    """Keys of the dict literal assigned to ``var`` in the reference's
    ``fn_name`` (e.g. ``run_http``'s ``full``)."""
    fn = _ref_function(fn_name)
    for n in ast.walk(fn):
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == var
                        for t in n.targets)):
            return _dict_keys(n.value)
    raise AssertionError(f"{fn_name} assigns no dict to {var}")


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
