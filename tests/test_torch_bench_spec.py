"""The serving bench's speculative-decoding section on the CPU
(``run_spec``, ``main --spec``) against the reference's report and
``main`` line; split from ``tests/test_torch_bench_serve.py`` so that
the suite's workers run the sections side by side."""

import ast
import dataclasses
import json

import pytest
import torch

from skypilot_tpu_torch.infer import bench_serve as tb
from torch_bench_ref import _dict_keys, _ref_function, _returned_keys
from skypilot_tpu_torch.models import llama as tl

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)


# -- the speculative-decoding section ----------------------------------------

def _first_gap(params, cfg, prompt, got, want):
    """(step, the plain path's top-2 logit gap there) at the first step
    where ``got`` and ``want`` part, or None where they agree."""
    from skypilot_tpu_torch.infer import kvcache as tkv
    t = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if t is None:
        return None
    ctx = list(prompt) + list(want[:t])
    _, logits = tkv.prefill_batch(params, torch.tensor([ctx]),
                                  torch.tensor([len(ctx)]), cfg,
                                  plain_attention=True)
    top = logits[0].topk(2).values
    return t, (top[0] - top[1]).item()


@pytest.fixture(scope="module")
def port_spec():
    """``run_spec(smoke=True)`` on llama3-tiny in float32 (the tiny
    config's bf16 puts near-ties everywhere), with the token lists
    behind its parity verdicts."""
    cfg = dataclasses.replace(tl.CONFIGS["llama3-tiny"],
                              dtype=torch.float32)
    real = tl.CONFIGS["llama3-tiny"]
    tl.CONFIGS["llama3-tiny"] = cfg
    try:
        toks = {}
        r = tb.run_spec(smoke=True, device="cpu", tokens_out=toks)
    finally:
        tl.CONFIGS["llama3-tiny"] = real
    return r, toks, cfg


def test_run_spec_report_has_the_reference_keys(port_spec):
    """``run_spec``'s smoke report has the reference's keys and meets
    the structure of its guard (``tests/test_spec_decode.py::
    test_spec_smoke_bench_wiring``): oracle acceptance exactly 1.0, the
    distilled drafter accepting > 0.9 where n-gram lookup is a wash,
    every pipelined predraft inside its verify's window with reuse, and
    fewer oracle rounds than one-token decoding would need. Greedy
    parity holds in every column, or a column parts only at a near-tie
    (the plain path's top-2 gap at most 1e-2): the port's kernel path,
    like the reference's, computes a verify round's staged columns as
    bf16 products."""
    from skypilot_tpu_torch.infer import draft as td
    r, toks, cfg = port_spec
    assert set(r) == _returned_keys("run_spec")
    assert r["backend"] == "cpu" and r["config"] == "llama3-tiny"
    assert (r["requests"], r["new_tokens"], r["spec_k"]) == (4, 96, 4)
    assert r["oracle_accept_rate"] == 1.0
    assert r["drafted"] > 0 and 0.0 <= r["accept_rate"] <= 1.0
    assert r["bursts_spec"] > 0 and r["bursts_oracle"] > 0
    assert (r["bursts_oracle"] * (r["spec_k"] + 1) * r["requests"]
            >= r["decode_tokens"])
    assert r["model_accept_rate"] > 0.9
    assert r["ngram_nonrep_accept_rate"] < 0.5
    assert r["overlap_ok"] and r["draft_records"] > 0
    assert r["draft_reuse_hits"] > 0 and r["draft_layers"] == 1
    gen = torch.Generator().manual_seed(0)
    params = tl.init_params(cfg, gen, device="cpu", dtype=cfg.dtype)
    target, _, _ = td.self_distilled_pair(params, cfg, 1)
    b_cfg = dataclasses.replace(cfg, vocab_size=16)
    gen = torch.Generator().manual_seed(0)
    b_params = tl.init_params(b_cfg, gen, device="cpu", dtype=cfg.dtype)
    prompts, off, *passes = toks["a"]
    verdicts = ("model_parity_ok", "model_sync_parity_ok",
                "ngram_nonrep_parity_ok")
    cases = [(target, cfg, prompts, off, got, v)
             for got, v in zip(passes, verdicts)]
    prompts, off, *passes = toks["b"]
    cases += [(b_params, b_cfg, prompts, off, got, v)
              for got, v in zip(passes, ("parity_ok", "oracle_parity_ok"))]
    for params_, cfg_, prompts, off, got, verdict in cases:
        assert r[verdict] == (got == off), verdict
        for p, a, b in zip(prompts, got, off):
            gap = _first_gap(params_, cfg_, p, a, b)
            assert gap is None or gap[1] <= 1e-2, (verdict, gap)
    # The model drafter's columns and the oracle's keep exact parity.
    assert r["model_parity_ok"] and r["model_sync_parity_ok"]
    assert r["parity_ok"] and r["oracle_parity_ok"]


def test_main_spec_prints_the_reference_line(capsys, monkeypatch):
    """``main --spec`` prints one JSON line with the keys of the
    reference's ``--spec`` line, plus the device, and passes
    ``--spec-k``."""
    fn = _ref_function("main")
    line = next(d for d in ast.walk(fn) if isinstance(d, ast.Dict)
                and "serve_spec_model_speedup" in
                {getattr(v, "value", None) for v in d.values})
    keys = _dict_keys(line) | {
        c.value for comp in ast.walk(line)
        if isinstance(comp, ast.DictComp)
        for c in ast.walk(comp.generators[0].iter)
        if isinstance(c, ast.Constant)}
    report = {k: 0 for k in _returned_keys("run_spec")}
    seen = []
    monkeypatch.setattr(tb, "run_spec",
                        lambda **kw: seen.append(kw) or report)
    tb.main(["--device", "cpu", "--spec", "--smoke", "--spec-k", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == keys | {"device"}
    assert out["metric"] == "serve_spec_model_speedup"
    assert seen[0]["spec_k"] == 3 and seen[0]["smoke"]
