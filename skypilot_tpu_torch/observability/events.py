"""Structured events of the port: one JSON object a line on stderr, the
event's name under ``"event"``. The port's stand-in for the reference's
tracing events (``skypilot_tpu/observability/tracing.py``'s
``add_event`` with ``echo=True``) until its tracing layer is ported.

Stdlib-only.
"""

import json
import sys


def emit(name: str, **attrs) -> None:
    print(json.dumps({"event": name, **attrs}), file=sys.stderr, flush=True)
