"""Assemble cross-process span trees from the structured event logs.

Copy of ``skypilot_tpu/observability/trace_view.py``.

``skytpu trace <request_id>`` backend: scan every per-process JSONL
event log (the API server's, each worker's, head-side rpc/skylet
daemons' — whatever shares the events dir), pick the records of one
trace, and render them as a duration-annotated tree or a Perfetto
(chrome trace-format) export.

Stdlib-only and CLI-independent so tests and other surfaces can reuse
the assembly.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.observability import tracing


def search_dirs() -> List[str]:
    """Event-log directories to scan: this home's ``events/`` plus any
    colon-separated extras in ``SKYTPU_TRACE_EXTRA_DIRS`` (how a trace
    spanning homes — e.g. local-cloud host workspaces — is assembled)."""
    dirs = [tracing.events_dir()]
    extra = os.environ.get("SKYTPU_TRACE_EXTRA_DIRS", "")
    dirs.extend(d for d in extra.split(":") if d)
    return dirs


def load_trace(trace_id: str,
               dirs: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """All records of ``trace_id`` across every log file in ``dirs``.
    Besides spans/events owned by the trace, flight-recorder burst
    records (``kind="flight"``) whose ``traces`` list names the trace
    match too — that is how ``skytpu trace <req>`` shows which engine
    bursts the request rode. Corrupt lines (a crash mid-line predates
    the atomic flush; foreign files) are skipped, never fatal."""
    records: List[Dict[str, Any]] = []
    for d in (dirs if dirs is not None else search_dirs()):
        for path in sorted(glob.glob(os.path.join(d, "*.jsonl"))):
            try:
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        # Substring pre-filter before json.loads: the
                        # trace id is a 32-hex literal embedded in any
                        # matching line, and parsing every record of
                        # every log to find one trace would make the
                        # CLI O(all records ever) in JSON decoding.
                        if trace_id not in line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if not isinstance(rec, dict):
                            continue
                        if (rec.get("trace") == trace_id
                                or trace_id in (rec.get("traces")
                                                or ())):
                            records.append(rec)
            except OSError:
                continue
    return records


def _dur_ms(rec: Dict[str, Any]) -> float:
    return max(float(rec["end_s"]) - float(rec["start_s"]), 0.0) * 1e3


def build_tree(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Parent/child assembly. Returns root nodes; each node is
    ``{"rec": record, "children": [nodes]}``. A span whose parent id
    never made it into any log (that process crashed pre-flush, or its
    log lives in an unscanned home) roots its own subtree rather than
    vanishing. Events attach to their parent span like child nodes."""
    spans = {r["span"]: {"rec": r, "children": []}
             for r in records if r.get("kind") == "span"}
    roots: List[Dict[str, Any]] = []
    for node in spans.values():
        parent = node["rec"].get("parent")
        if parent and parent in spans:
            spans[parent]["children"].append(node)
        else:
            roots.append(node)
    for r in records:
        if r.get("kind") != "event":
            continue
        node = {"rec": r, "children": []}
        parent = r.get("parent")
        if parent and parent in spans:
            spans[parent]["children"].append(node)
        else:
            roots.append(node)

    def _key(n):
        rec = n["rec"]
        return float(rec.get("start_s", rec.get("ts_s", 0.0)))

    for node in spans.values():
        node["children"].sort(key=_key)
    roots.sort(key=_key)
    return roots


def render(records: List[Dict[str, Any]],
           trace_id: Optional[str] = None) -> str:
    """Human tree view: one line per span (duration, process/pid,
    error marker) with events inlined under their parent span."""
    if not records:
        return "no events recorded for this trace"
    trace_id = trace_id or records[0].get("trace", "?")
    n_spans = sum(1 for r in records if r.get("kind") == "span")
    procs = {(r.get("proc"), r.get("pid")) for r in records}
    lines = [f"trace {trace_id} — {n_spans} span"
             f"{'s' if n_spans != 1 else ''}, {len(procs)} process"
             f"{'es' if len(procs) != 1 else ''}"]

    def walk(node, prefix: str, is_last: bool) -> None:
        rec = node["rec"]
        branch = "└─ " if is_last else "├─ "
        where = f"[{rec.get('proc', '?')}/{rec.get('pid', '?')}]"
        if rec.get("kind") == "span":
            flag = ""
            if rec.get("status") == "error":
                flag = f"  !ERROR {rec.get('error_type') or ''}".rstrip()
            attrs = rec.get("attrs") or {}
            attr_s = ""
            if attrs:
                attr_s = " " + " ".join(
                    f"{k}={v}" for k, v in sorted(attrs.items()))
            lines.append(f"{prefix}{branch}{rec['name']}  "
                         f"{_dur_ms(rec):.1f}ms  {where}{attr_s}{flag}")
        else:
            attrs = rec.get("attrs") or {}
            attr_s = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
            lines.append(f"{prefix}{branch}• {rec['name']}  {where}"
                         f"{(' ' + attr_s) if attr_s else ''}")
        kids = node["children"]
        child_prefix = prefix + ("   " if is_last else "│  ")
        for i, child in enumerate(kids):
            walk(child, child_prefix, i == len(kids) - 1)

    roots = build_tree(records)
    for i, root in enumerate(roots):
        walk(root, "", i == len(roots) - 1)

    # Flight-recorder bursts the trace's request(s) rode: not part of
    # the span tree (one burst serves many requests), rendered as a
    # timeline section under it instead.
    flights = sorted((r for r in records if r.get("kind") == "flight"),
                     key=lambda r: float(r.get("ts_s", 0.0)))
    if flights:
        from skypilot_tpu_torch.observability import flight as flight_lib
        t0 = float(flights[0].get("ts_s", 0.0))
        lines.append("")
        lines.append(f"bursts ridden ({len(flights)}):")
        for r in flights:
            where = f"[{r.get('proc', '?')}/{r.get('pid', '?')}]"
            extra = []
            if r.get("drafted"):
                extra.append(f"spec {r.get('accepted', 0)}"
                             f"/{r.get('drafted', 0)}")
            if r.get("stall"):
                extra.append("stall")
            if r.get("compiled"):
                extra.append(f"COMPILED={len(r['compiled'])}")
            lines.append(
                f"  +{(float(r.get('ts_s', t0)) - t0) * 1e3:8.1f}ms  "
                f"{flight_lib.program_label(r):<36} "
                f"slots={len(r.get('slots', ()))} "
                f"toks={r.get('toks', 0)}"
                f"{('  ' + ' '.join(extra)) if extra else ''}  {where}")
    return "\n".join(lines)


def to_perfetto(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-format export (Perfetto/chrome://tracing loadable):
    spans as complete ('X') events, lifecycle events as instants, plus
    process_name metadata so tracks are labeled by process."""
    events: List[Dict[str, Any]] = []
    named_pids = set()
    for r in records:
        pid = r.get("pid", 0)
        tid = r.get("tid", pid)
        if pid not in named_pids:
            named_pids.add(pid)
            events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"{r.get('proc', '?')}/{pid}"}})
        args = dict(r.get("attrs") or {})
        if r.get("status") == "error":
            args["status"] = "error"
            if r.get("error_type"):
                args["error_type"] = r["error_type"]
        if r.get("kind") == "span":
            events.append({
                "name": r["name"], "ph": "X",
                "ts": float(r["start_s"]) * 1e6,
                "dur": max(float(r["end_s"]) - float(r["start_s"]), 0.0)
                * 1e6,
                "pid": pid, "tid": tid, "args": args})
        elif r.get("kind") == "event":
            events.append({
                "name": r["name"], "ph": "i",
                "ts": float(r["ts_s"]) * 1e6,
                "pid": pid, "tid": tid, "s": "p", "args": args})
        elif r.get("kind") == "flight":
            from skypilot_tpu_torch.observability import flight as flight_lib
            args = dict(args)
            args.update({k: r[k] for k in ("toks", "rids", "drafted",
                                           "accepted", "compiled",
                                           "adapters")
                         if r.get(k)})
            args["slots"] = len(r.get("slots", ()))
            events.append({
                "name": flight_lib.program_label(r), "ph": "X",
                "ts": float(r.get("ts_s", 0.0)) * 1e6,
                "dur": max(float(r.get("dur_s", 0.0)), 0.0) * 1e6,
                "pid": pid, "tid": tid, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
