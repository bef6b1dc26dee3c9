"""Serving over the port's engine: the microbatching ``AqpService`` and the
multi-tenant front over it (``repro_torch.serving.front``: admission,
per-tenant metrics, the JSON wire codec and the HTTP/NDJSON transport).

``repro_torch.serving.engine`` holds the LM stack's serving steps
(prefill, one-token decode, greedy ``generate``), as the reference's
``serving/engine.py`` does.
"""
from repro_torch.serving.aqp import AqpService, Ticket
from repro_torch.serving.engine import make_prefill_step, make_serve_step
from repro_torch.serving.front import (
    Rejection,
    ServingFront,
    TenantSpec,
    serve_http,
)

__all__ = ["AqpService", "Rejection", "ServingFront", "TenantSpec", "Ticket",
           "make_prefill_step", "make_serve_step", "serve_http"]
