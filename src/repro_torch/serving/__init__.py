"""Serving over the port's engine: the microbatching ``AqpService``.

The reference's ``repro.serving`` also holds the LM stack's decoder
(``serving/engine.py``) and the HTTP front (``serving/front``); neither is
ported yet.
"""
from repro_torch.serving.aqp import AqpService, Ticket

__all__ = ["AqpService", "Ticket"]
