"""Operations and bytes a kernel's call needs, from its arguments' shapes.

Each input byte counts once and each output byte once, whatever a kernel
reads again; every add, multiply, divide, compare, exp and erf counts as
one operation. The counts follow the ones the port's smoke script states
for K1 and K3, so that a share here and there mean the same.
"""
from __future__ import annotations


def scan(t: int, q: int, l: int, c: int, v: int, m: int) -> tuple:
    """The fused masked scan over ``t`` tuples and ``q`` snippets (as
    passed, padding included), ``l`` numeric and ``c`` categorical
    dimensions of ``v`` values at most, ``m`` measures: (bytes, operations,
    rate). Reads the tuples (f64 dims, int32 codes, f64 measures) and the
    snippets (bounds, category sets); writes ``2m + 1`` f64 partials a
    snippet. A tuple and a snippet cost 2l compares, c lookups and the fold
    of ``[m, m^2, 1]``: ``2 (2m + 1)``."""
    n_bytes = (t * (8 * l + 4 * c + 8 * m) + q * (16 * l + c * v)
               + q * (2 * m + 1) * 8)
    n_ops = t * q * (2 * l + c + 2 * (2 * m + 1))
    return n_bytes, n_ops, "float64"


def covariance(n_i: int, n_j: int, l: int, gram: bool) -> tuple:
    """The squared-exponential covariance of ``n_i`` against ``n_j``
    snippets over ``l`` numeric dimensions (``gram``: a set against
    itself, each symmetric pair computed once): (bytes, operations, rate).
    An antiderivative is 9 operations and an entry 4 l of them, 5 a
    dimension for the inclusion-exclusion, clamp and product, and 3 for
    the scales. Reads both sides' bounds and norms, writes the matrix."""
    pairs = n_i * n_j
    if gram:
        evals = n_i * (n_i + 1) // 2
        n_bytes = 8 * (2 * n_i * l + l + n_i + 1 + pairs)
    else:
        evals = pairs
        n_bytes = 8 * (2 * (n_i + n_j) * l + l + n_i + n_j + 1 + pairs)
    n_ops = evals * 4 * 9 * l + pairs * (5 * l + 3)
    return n_bytes, n_ops, "float64_simt"
