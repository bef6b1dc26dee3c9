"""Serving over the port's engine: the microbatching ``AqpService`` and the
multi-tenant front over it (``repro_torch.serving.front``: admission,
per-tenant metrics, the JSON wire codec and the HTTP/NDJSON transport).

The reference's ``repro.serving`` also holds the LM stack's decoder
(``serving/engine.py``); it is not ported yet.
"""
from repro_torch.serving.aqp import AqpService, Ticket
from repro_torch.serving.front import (
    Rejection,
    ServingFront,
    TenantSpec,
    serve_http,
)

__all__ = ["AqpService", "Rejection", "ServingFront", "TenantSpec", "Ticket",
           "serve_http"]
