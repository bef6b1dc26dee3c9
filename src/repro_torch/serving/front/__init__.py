"""Multi-tenant serving front (``repro_torch.serving.front``).

The network-facing layer over the microbatching ``AqpService``: per-tenant
sessions with isolated-or-shared learned-state namespaces, clock-free
admission control (token bucket + bounded queue, typed ``Rejection``),
per-tenant observability (latency histograms + outcome counters), a JSON
wire codec, and a stdlib HTTP transport with an NDJSON streaming endpoint.
"""
from repro_torch.serving.front.admission import (
    AdmissionConfig,
    AdmissionController,
    Rejection,
    TokenBucket,
)
from repro_torch.serving.front.front import ServingFront, Tenant, TenantSpec
from repro_torch.serving.front.http import FrontHTTPServer, serve_http
from repro_torch.serving.front.metrics import LatencyHistogram, TenantMetrics
from repro_torch.serving.front.wire import (
    WireError,
    answer_to_json,
    budget_from_json,
    query_from_json,
    report_to_json,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "FrontHTTPServer",
    "LatencyHistogram",
    "Rejection",
    "ServingFront",
    "Tenant",
    "TenantMetrics",
    "TenantSpec",
    "TokenBucket",
    "WireError",
    "answer_to_json",
    "budget_from_json",
    "query_from_json",
    "report_to_json",
    "serve_http",
]
