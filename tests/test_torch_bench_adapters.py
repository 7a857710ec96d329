"""The serving bench's adapter section on the CPU (``run_adapters``,
``main --adapters``) against the reference's report and ``main`` line;
split from ``tests/test_torch_bench_serve.py`` so that the suite's
workers run the sections side by side."""

import ast
import json

import pytest
import torch

from skypilot_tpu_torch.infer import bench_serve as tb
from torch_bench_ref import _dict_keys, _ref_function, _returned_keys

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)


# -- the adapter section ------------------------------------------------------

@pytest.fixture(scope="module")
def port_adapters():
    return tb.run_adapters_smoke(device="cpu")


def test_run_adapters_report_has_the_reference_keys(port_adapters):
    """``run_adapters_smoke()``'s report has the keys of the reference's
    ``run_adapters`` and meets its own guard (``tests/test_adapters.py::
    test_adapter_smoke_bench``): greedy parity, hot loads and evictions
    in the churn, a positive overhead ratio, and no program key first
    dispatched after the warm-up while adapters hot-load."""
    r = port_adapters
    assert set(r) == _returned_keys("run_adapters")
    assert r["parity_ok"]
    assert r["hot_loads"] > 0 and r["evictions"] > 0
    assert r["overhead_ratio"] > 0 and r["unexpected_compiles"] == 0
    assert (r["n_adapters"], r["rank"], r["requests"],
            r["new_tokens"]) == (4, 4, 4, 32)


def test_main_adapters_prints_the_reference_line(capsys, monkeypatch):
    """``main --adapters`` prints one JSON line with the keys of the
    reference's ``--adapters`` line, plus the device."""
    fn = _ref_function("main")
    line = next(d for d in ast.walk(fn) if isinstance(d, ast.Dict)
                and "serve_adapter_overhead" in
                {getattr(v, "value", None) for v in d.values})
    keys = _dict_keys(line) | {
        c.value for comp in ast.walk(line)
        if isinstance(comp, ast.DictComp)
        for c in ast.walk(comp.generators[0].iter)
        if isinstance(c, ast.Constant)}
    report = {k: 0 for k in _returned_keys("run_adapters")}
    seen = []
    monkeypatch.setattr(tb, "run_adapters",
                        lambda **kw: seen.append(kw) or report)
    tb.main(["--device", "cpu", "--adapters", "--smoke", "--n-adapters",
             "3"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == keys | {"device"}
    assert out["metric"] == "serve_adapter_overhead"
    assert seen[0]["n_adapters"] == 3 and seen[0]["smoke"]
