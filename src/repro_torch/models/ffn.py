"""Dense FFN and expert-parallel MoE.

MoE dispatch is the reference's: top-k routing with renormalised float32
softmax gates; each (token, choice) pair routed to one of this position's
experts, in token-major order, takes the next free slot of its expert's
(capacity + 1)-row buffer (its rank from a one-hot cumsum, pairs routed
elsewhere counted in a sentinel column); pairs past capacity go to the
spill row, which is sliced away (dropped tokens, as in GShard/Switch);
batched expert matmuls; each token's k contributions gathered back and
summed in choice order.

Expert parallelism (``ShardCtx`` with a mesh): the tokens split over the
mesh's batch axes and the experts over its model axis. Each position runs
its token shard against its ``E / tp`` experts on its own device, with the
capacity from the **local** token count; the router is replicated, so the
model axis only masks experts and never re-routes. A token shard's
partial outputs are summed over the model axis in index order (the
reference's psum) and the shards gathered back onto the input's device.
Axes of the mesh that are neither replicate the work: their index 0
computes. Expert weights are sliced, not copied: on a mesh that lists one
card several times each position's experts are views of the one tensor.

Capacity: max(int(top_k·N/E · capacity_factor), 4), N the tokens of the
position's shard.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import report_collective
from repro_torch.models.common import ShardCtx, activate


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


def _moe_experts(cfg, p, x_flat, e_lo, e_local, capacity):
    """Scatter-dispatch -> batched expert matmuls -> gather-combine.

    ``p`` holds the *local* expert weight slices (E_local, ...); the (full,
    replicated) router produces global expert ids and tokens routed to
    [e_lo, e_lo + e_local) are processed here. Returns this position's
    partial output (N, d): the model axis' sum completes the MoE.
    """
    gates, idx = _route(cfg, x_flat @ p["router"])
    n, d = x_flat.shape
    k = cfg.moe.top_k

    flat_idx = idx.reshape(-1)  # (N*k,) global expert ids, (token, choice)
    flat_gate = gates.reshape(-1)
    local = (flat_idx >= e_lo) & (flat_idx < e_lo + e_local)
    local_e = torch.where(local, flat_idx - e_lo, e_local)  # sentinel e_local
    # Rank of each (token, choice) within its expert queue (1-based cumsum).
    onehot = torch.nn.functional.one_hot(local_e, e_local + 1).to(torch.int32)
    slot = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = local & (slot < capacity)
    slot = torch.where(keep, slot, capacity)  # overflow -> spill slot

    tok = torch.arange(n, device=x_flat.device).repeat_interleave(k)
    rows = torch.where(keep[:, None], x_flat[tok], 0.0)
    buf = torch.zeros((e_local + 1, capacity + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    # Kept pairs own distinct (expert, slot) cells; the sentinel expert and
    # the spill row get only zeros. So a plain write gives the reference's
    # scatter-add exactly.
    buf.index_put_((local_e, slot), rows)
    buf = buf[:e_local, :capacity]  # (E_local, C, d)

    h = activate(cfg.act, torch.bmm(buf, p["we_g"]), torch.bmm(buf, p["we_u"]))
    out_buf = torch.bmm(h, p["we_d"])  # (E_local, C, d)

    gathered = out_buf[local_e.clamp(max=e_local - 1),
                       slot.clamp(max=capacity - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    contrib = gathered * flat_gate[:, None].to(gathered.dtype)
    return contrib.reshape(n, k, d).sum(1)


def _capacity(m, n: int) -> int:
    return max(int(n * m.top_k / m.n_experts * m.capacity_factor), 4)


def _moe_mesh(cfg, p, x_flat, sctx: ShardCtx):
    """The routed experts' output (N, d) over ``sctx.mesh``: token shards
    over the batch axes, experts over the model axis, on each position's
    device; gathered back onto ``x_flat``'s device."""
    mesh, m = sctx.mesh, cfg.moe
    shape = mesh.shape
    tp = shape[sctx.model_axis]
    if m.n_experts % tp:
        raise ValueError(f"{m.n_experts} experts do not split over "
                         f"{sctx.model_axis}={tp}")
    e_per = m.n_experts // tp
    b_axes = tuple(sctx.batch_axes)
    dp = 1
    for a in b_axes:
        dp *= shape[a]
    n = x_flat.shape[0]
    if n % dp:
        raise ValueError(f"{n} tokens do not split over {b_axes}={dp}")
    rows = n // dp
    cap = _capacity(m, rows)
    outs = []
    for b in range(dp):
        coords, r = {}, b
        for a in reversed(b_axes):  # the first batch axis major
            r, coords[a] = divmod(r, shape[a])
        total = None
        for j in range(tp):
            dev = mesh.device_at({**coords, sctx.model_axis: j})
            sl = slice(j * e_per, (j + 1) * e_per)
            pp = {"router": p["router"].to(dev),
                  **{w: p[w][sl].to(dev) for w in ("we_g", "we_u", "we_d")}}
            part = _moe_experts(cfg, pp, x_flat[b * rows:(b + 1) * rows]
                                .to(dev), j * e_per, e_per, cap)
            total = part if total is None else total + part.to(total.device)
        outs.append(total.to(x_flat.device))
    # the sum over the model axis: the reference's psum of a position's
    # (rows, d) partial, one a call
    report_collective("all-reduce", outs[0])
    return torch.cat(outs)


def moe_ffn(cfg, p, x, sctx: ShardCtx = ShardCtx()):
    """x: (B,S,d) -> (B,S,d). Expert-parallel over ``sctx.model_axis``
    when ``sctx`` has a mesh; on ``x``'s device otherwise."""
    b, s, d = x.shape
    m = cfg.moe
    x_flat = x.reshape(b * s, d)
    if sctx.enabled:
        out_flat = _moe_mesh(cfg, p, x_flat, sctx)
    else:
        out_flat = _moe_experts(cfg, p, x_flat, 0, m.n_experts,
                                _capacity(m, b * s))
    out = out_flat.reshape(b, s, d)
    if m.shared_expert:
        out = out + dense_ffn(cfg, p["shared"], x)
    if m.dense_residual:
        out = out + dense_ffn(cfg, p["dense"], x)
    return out
