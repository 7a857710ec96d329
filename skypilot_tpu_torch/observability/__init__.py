"""Live observability of the port: the process-global metrics registry
and its exposition (:mod:`.metrics`), and the ``/healthz`` answer
(:mod:`.health`), per-request tracing (:mod:`.tracing`,
:mod:`.trace_view`), the engine's flight recorder and compile watch
(:mod:`.flight`), device-time attribution and the HBM ledger
(:mod:`.attribution`) and request forensics (:mod:`.forensics`): copies
of the reference's modules under ``skypilot_tpu/observability/``, the
device-facing parts of :mod:`.attribution` the card's own.

``from skypilot_tpu_torch.observability import metrics`` is the one
import an instrumentation site needs; declare families at module import
with ``metrics.counter/gauge/histogram`` and record on the hot path.
"""

from skypilot_tpu_torch.observability.metrics import (  # noqa: F401
    CONTENT_TYPE,
    Counter,
    Gauge,
    Histogram,
    Metric,
    REGISTRY,
    Registry,
    counter,
    gauge,
    histogram,
    render,
)
