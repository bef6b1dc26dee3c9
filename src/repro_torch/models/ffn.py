"""Dense FFN and the single-device MoE.

MoE dispatch is the reference's, on one device: top-k routing with
renormalised float32 softmax gates; each (token, choice) pair, in
token-major order, takes the next free slot of its expert's
(capacity + 1)-row buffer (its rank from a one-hot cumsum); pairs past
capacity go to the spill row, which is sliced away (dropped tokens, as in
GShard/Switch); batched expert matmuls; each token's k contributions
gathered back and summed in choice order.

Capacity: max(int(top_k·N/E · capacity_factor), 4). The reference's
expert-parallel path (a shard_map over the mesh's model axis) comes with
``ShardCtx``'s mesh in the port of ``distributed/*``.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activate


def dense_ffn(cfg, p, x):
    if "wg" in p:
        h = activate(cfg.act, x @ p["wg"], x @ p["wu"])
    else:
        h = activate("gelu_mlp", x @ p["wi"])
    return h @ p["wd"]


def _route(cfg, router_logits):
    """Top-k routing with renormalized softmax gates.

    ``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk`` does
    not (on the CPU it returns ``[2, 4, 1]`` for ``[1, 3, 3, 2, 3]``). In
    bfloat16 router logits tie often enough to matter, so the experts are
    taken from a stable descending sort, which keeps equal logits in index
    order.
    """
    gates, idx = torch.sort(router_logits, stable=True, dim=-1,
                            descending=True)
    k = cfg.moe.top_k
    return torch.softmax(gates[:, :k].float(), dim=-1), idx[:, :k]


def _moe_experts(cfg, p, x_flat, capacity):
    """Scatter-dispatch -> batched expert matmuls -> gather-combine over
    all ``E`` experts. Returns the routed experts' output (N, d)."""
    gates, idx = _route(cfg, x_flat @ p["router"])
    n, d = x_flat.shape
    k = cfg.moe.top_k
    e = cfg.moe.n_experts

    flat_e = idx.reshape(-1)  # (N*k,) expert ids, (token, choice) order
    flat_gate = gates.reshape(-1)
    # Rank of each (token, choice) within its expert queue (1-based cumsum).
    onehot = torch.nn.functional.one_hot(flat_e, e).to(torch.int32)
    slot = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = slot < capacity
    slot = torch.where(keep, slot, capacity)  # overflow -> spill slot

    tok = torch.arange(n, device=x_flat.device).repeat_interleave(k)
    rows = torch.where(keep[:, None], x_flat[tok], 0.0)
    buf = torch.zeros((e, capacity + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    # Kept pairs own distinct (expert, slot) cells; the spill row gets only
    # zeros. So a plain write gives the reference's scatter-add exactly.
    buf.index_put_((flat_e, slot), rows)
    buf = buf[:, :capacity]  # (E, C, d)

    h = activate(cfg.act, torch.bmm(buf, p["we_g"]), torch.bmm(buf, p["we_u"]))
    out_buf = torch.bmm(h, p["we_d"])  # (E, C, d)

    gathered = out_buf[flat_e, slot.clamp(max=capacity - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    contrib = gathered * flat_gate[:, None].to(gathered.dtype)
    return contrib.reshape(n, k, d).sum(1)


def moe_ffn(cfg, p, x):
    """x: (B,S,d) -> (B,S,d) on one device."""
    b, s, d = x.shape
    m = cfg.moe
    n = b * s
    capacity = max(int(n * m.top_k / m.n_experts * m.capacity_factor), 4)
    out = _moe_experts(cfg, p, x.reshape(n, d), capacity).reshape(b, s, d)
    if m.shared_expert:
        out = out + dense_ffn(cfg, p["shared"], x)
    if m.dense_residual:
        out = out + dense_ffn(cfg, p["dense"], x)
    return out
