"""Helpers shared by the serving bench's tests
(``tests/test_torch_bench_*.py``): the reference bench's report keys,
read from its source (``skypilot_tpu/infer/bench_serve.py``)."""

import ast
import os
import pathlib

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
