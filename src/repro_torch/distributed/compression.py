"""Cross-pod gradient compression: int8 quantized exchange with error
feedback, the reference's ``repro.distributed.compression``.

The cross-pod gradient all-reduce is the slowest link of a multi-pod run.
This module replaces it with an int8 exchange between pods (one partner
each, ``ppermute``) and a local dequantize-and-average, with per-tensor
scales and an error-feedback residual (1-bit/8-bit SGD lineage: Seide et
al. 2014, Bernstein et al. 2018).

The placement is one process's: a value "at" a position of a mesh axis is
one entry of a list indexed by the axis coordinate, on that position's
device (index 0 of the other axes). ``ppermute`` is the only place a value
crosses between positions, so what crosses (int8 ``q``, float32 ``scale``)
is what a caller that wraps it sees.

Properties of the reference kept as they are:
  - ``make_compressed_train_step`` drops the error-feedback residual;
  - for more than two pods ``compressed_pair_mean`` adds a position's own
    value and one peer's and divides by the pod count, which is not the
    mean; the step keeps pod 0's result, the replica the reference's step
    returns.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import report_collective, tree_map
from repro_torch.models.common import ShardCtx
from repro_torch.models.params import tree_leaves
from repro_torch.models.params import tree_map as params_map
from repro_torch.training.train_loop import accumulated_grads, clip_in_place


def quantize_int8(x):
    """(q, scale): x / scale rounded half to even and clipped to +-127 as
    int8, scale = max|x| / 127 (at least 1e-30 / 127), a float32 0-dim
    tensor on x's device. Both divisions are true divisions."""
    top = torch.clamp(torch.amax(torch.abs(x)), min=1e-30)
    scale = top / torch.full((), 127.0, dtype=top.dtype, device=x.device)
    t = x / scale
    q = t.round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def ppermute(xs, mesh, axis: str, perm):
    """``jax.lax.ppermute`` over a mesh axis: ``xs[i]`` (a tree) is the
    value at coordinate ``i`` of ``axis``; each ``(src, dst)`` pair of
    ``perm`` hands ``xs[src]`` to ``dst`` on its device. A coordinate that
    no pair sends to receives zeros. Returns the list by coordinate."""
    devices = mesh.axis_devices(axis)
    out = [None] * len(devices)
    for src, dst in perm:
        out[dst] = tree_map(lambda t: t.to(devices[dst]), xs[src])
    if perm:  # what one position receives: a collective-permute a tensor
        report_collective("collective-permute", xs[perm[0][0]])
    return [tree_map(torch.zeros_like, xs[i]) if o is None else o
            for i, o in enumerate(out)]


def _pair_means(payloads, mesh, axis: str, keep):
    """``{i: means}`` for the coordinates ``keep`` of ``axis``: each
    coordinate's list of ``(q, scale)`` payloads exchanged with its
    predecessor's by one ``ppermute``, then (own + peer) / n, leaf by
    leaf."""
    n = mesh.shape[axis]
    recv = ppermute(payloads, mesh, axis, [(i, (i + 1) % n) for i in range(n)])
    return {i: [(dequantize(*own) + dequantize(*peer)) / n
                for own, peer in zip(payloads[i], recv[i])] for i in keep}


def compressed_pair_mean(xs, mesh, axis: str = "pod"):
    """Mean of ``xs`` (one tensor a coordinate of ``axis``) across a
    2-member axis via int8 ppermute exchange.

    Returns (means, error-feedback residuals), each one a coordinate.
    """
    payloads = [[quantize_int8(x)] for x in xs]
    resid = [x - dequantize(*p[0]) for x, p in zip(xs, payloads)]
    means = _pair_means(payloads, mesh, axis, range(len(xs)))
    return [means[i][0] for i in range(len(xs))], resid


def tree_compressed_mean(trees, mesh, axis: str = "pod"):
    """``compressed_pair_mean`` of every float32-cast leaf of ``trees``
    (one tree a coordinate of ``axis``), the payloads of all leaves in one
    exchange. Returns (mean trees, residual trees), one a coordinate."""
    flat = [[x.float() for _, x in tree_leaves(t)] for t in trees]
    payloads = [[quantize_int8(x) for x in xs] for xs in flat]
    means = _pair_means(payloads, mesh, axis, range(len(trees)))

    def unflat(tree, leaves):
        it = iter(leaves)
        return params_map(lambda _: next(it), tree)

    mean = [unflat(t, means[i]) for i, t in enumerate(trees)]
    resid = [unflat(t, [x - dequantize(*p) for x, p in zip(xs, ps)])
             for t, xs, ps in zip(trees, flat, payloads)]
    return mean, resid


def make_compressed_train_step(cfg, opt, mesh, *, accum: int = 1,
                               clip_norm: float = 1.0):
    """Train step with pod-axis data parallelism and the int8 compressed
    gradient exchange. Returns step(params, opt_state, batch, lr) ->
    (params, opt_state, metrics); ``params`` and ``opt_state`` are updated
    in place, once.

    Parameters and optimizer state are pod-replicated: one tree, which
    every pod reads (moved to the pod's device), so a mesh that lists one
    card several times holds a single copy. Batch leaves (accum, micro,
    ...) split their micro dim over the pods. Pod ``i`` takes the
    gradients of its rows over its ``(data, model)`` sub-mesh (MoE layers
    expert-parallel there) and quantizes them leaf by leaf before the next
    pod's backward, so one pod's float32 gradients are held at a time.
    After the exchange, pod 0's mean is clipped and applied; ``loss`` is
    the pods' mean loss and ``grad_norm`` pod 0's norm before clipping.
    """
    pods = mesh.shape["pod"]

    def step(params, opt_state, batch, lr):
        micro = next(iter(batch.values())).shape[1]
        if micro % pods:
            raise ValueError(f"a micro batch of {micro} rows does not split "
                             f"over {pods} pods")
        rows = micro // pods
        payloads, losses = [], []
        for i in range(pods):
            sub = mesh.sub_mesh("pod", i)
            dev = sub.devices[0]
            mine = params_map(lambda t: t.to(dev), params)
            part = {k: v[:, i * rows:(i + 1) * rows].to(dev)
                    for k, v in batch.items()}
            loss, grads = accumulated_grads(
                cfg, mine, part, ShardCtx(mesh=sub, batch_axes=("data",)),
                accum=accum)
            del mine
            sent = []
            for j in range(len(grads)):
                sent.append(quantize_int8(grads[j].float()))
                grads[j] = None  # free each leaf once quantized
            payloads.append(sent)
            losses.append(loss)
            del grads, sent
        means = _pair_means(payloads, mesh, "pod", (0,))[0]
        del payloads
        loss = losses[0]
        for x in losses[1:]:  # the pods' losses in pod order
            loss = loss + x.to(loss.device)
        report_collective("all-reduce", loss)  # the reference's pmean
        it = iter(means)
        grads = params_map(lambda _: next(it), params)
        del means, it
        gnorm = clip_in_place(grads, clip_norm)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, {"loss": loss / pods, "grad_norm": gnorm}

    return step
