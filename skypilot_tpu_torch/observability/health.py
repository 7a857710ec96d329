"""Component health: the ``GET /healthz`` answer of a port replica.

The replica's half of ``skypilot_tpu/observability/health.py`` (the
status constants, :func:`healthz_payload` and :func:`write_healthz`),
copied so that the fleet health model reads a GPU replica as it reads a
TPU one. Every answer has the same shape::

    {"status": "healthy" | "draining" | "degraded" | "dead",
     "reason": <human string>,
     "last_seen_s": <seconds since the component last showed life>}

The fleet-probe half (HTTP and RPC probes, the rollup) stays in the
reference: no port process probes other components.
"""

from __future__ import annotations

import json
from typing import Any, Dict

HEALTHY = "healthy"
# Draining: deliberately refusing NEW work while in-flight requests
# finish (graceful drain ahead of a rolling-update kill). A replica
# draining past its deadline self-reports degraded instead.
DRAINING = "draining"
DEGRADED = "degraded"
DEAD = "dead"


def healthz_payload(status: str, reason: str = "",
                    last_seen_s: float = 0.0) -> Dict[str, Any]:
    """The body every ``GET /healthz`` returns."""
    return {"status": status, "reason": reason,
            "last_seen_s": round(last_seen_s, 3)}


def write_healthz(handler, status: str, reason: str = "",
                  last_seen_s: float = 0.0) -> None:
    """Serve ``GET /healthz`` on a ``BaseHTTPRequestHandler``: 200 for
    every status (the probe succeeded; the STATUS carries the verdict),
    so only an unreachable process reads as dead."""
    body = json.dumps(healthz_payload(status, reason,
                                      last_seen_s)).encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)
