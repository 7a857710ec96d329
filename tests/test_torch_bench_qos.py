"""The serving bench's QoS section on the CPU (``run_qos``, ``main
--qos``) against the reference's report and ``main`` line; split from
``tests/test_torch_bench_serve.py`` so that the suite's workers run the
sections side by side."""

import ast
import json

import pytest
import torch

from skypilot_tpu_torch.infer import bench_serve as tb
from torch_bench_ref import _dict_keys, _ref_function, _returned_keys

# One intra-op thread: the suite runs several test files at once on a
# few cores, and these tiny products gain nothing from more threads.
torch.set_num_threads(1)


# -- the QoS section ----------------------------------------------------------

@pytest.fixture(scope="module")
def port_qos():
    return tb.run_qos_smoke(device="cpu")


def test_run_qos_report_has_the_reference_keys(port_qos):
    """``run_qos``'s report has the reference's keys, and its smoke pass
    meets the reference's own guard (``tests/test_qos.py::
    test_bench_qos_smoke``): scheduling and preemption parity, at least
    one preemption, and WFQ admitting the background tenant far ahead of
    FIFO."""
    assert set(port_qos) == _returned_keys("run_qos")
    assert port_qos["preempt_parity_ok"] and port_qos["sched_parity_ok"]
    assert port_qos["preemptions"] >= 1
    assert port_qos["preempt_resumed_rows"] > 0
    assert port_qos["bg_ttft_wfq_ratio"] < port_qos["bg_ttft_fifo_ratio"]
    assert (port_qos["slots"], port_qos["hot_requests"],
            port_qos["new_tokens"]) == (4, 12, 16)


def test_main_qos_prints_the_reference_line(capsys, monkeypatch):
    """``main --qos`` prints one JSON line with the keys of the
    reference's ``--qos`` line, plus the device."""
    fn = _ref_function("main")
    line = next(d for d in ast.walk(fn) if isinstance(d, ast.Dict)
                and "serve_qos_fairness_ratio" in
                {getattr(v, "value", None) for v in d.values})
    keys = _dict_keys(line) | {
        c.value for comp in ast.walk(line)
        if isinstance(comp, ast.DictComp)
        for c in ast.walk(comp.generators[0].iter)
        if isinstance(c, ast.Constant)}
    report = {k: 0 for k in _returned_keys("run_qos")}
    monkeypatch.setattr(tb, "run_qos", lambda **kw: report)
    tb.main(["--device", "cpu", "--qos", "--smoke"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == keys | {"device"}
    assert out["metric"] == "serve_qos_fairness_ratio"
