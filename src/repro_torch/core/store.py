"""SynopsisStore: the placement-aware home of ALL learned state.

The query lifecycle (``repro_torch.aqp.plan``) talks to the store and never
to raw ``Synopsis`` dicts. Store protocol:

- ``for_key(key)`` / ``get(key)`` and the mapping methods — per-aggregate-key
  synopsis lookup, created on demand on the key's device;
- ``improve_groups(snippets, raw)`` — the per-aggregate-key improvement of a
  mixed snippet batch, scattered back to query order (Algorithm 2 lines
  3-7): one ``gp_batch_infer`` launch per aggregate key, as the reference's
  kernel branch does, grouped by device;
- ``record(snippets, raw)`` — enqueue final raw answers for learning
  (async per synopsis);
- ``drain`` / ``refit`` / ``ingest_stats`` / ``quarantined`` / ``heal`` /
  ``stats``;
- ``state_dict`` / ``load_state_dict`` — ``"agg<k>-measure<m>"``-keyed,
  shard-tagged numpy payloads in the reference's layout, so a JAX engine's
  ``synopses_state_dict()`` loads here as it is.

Two implementations: ``LocalSynopsisStore`` keeps every synopsis on one
device; ``ShardedSynopsisStore`` places each key's synopsis on a device of a
mesh (a hash of the key modulo the device count), drains the shards
concurrently and reports per-shard occupancy. Placement moves work, never
values: both answer alike.
"""
from __future__ import annotations

import re
import threading
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.synopsis import Synopsis
from repro_torch.core.types import (
    AVG,
    F64,
    ImprovedAnswer,
    RawAnswer,
    SnippetBatch,
    resolve_device,
    to_numpy,
)
from repro_torch.utils import tracing

AggKey = Tuple[int, int]

_STATE_KEY_RE = re.compile(r"^agg(\d+)-measure(\d+)$")


def agg_key(agg: int, measure: int) -> AggKey:
    """Canonical aggregate-function key: (agg, measure), FREQ collapses
    measure to 0 (frequency snippets are measure-oblivious, paper §2.3)."""
    agg = int(agg)
    return (agg, int(measure) if agg == AVG else 0)


def state_key(key: AggKey) -> str:
    """Structured checkpoint key for one aggregate-function synopsis."""
    return f"agg{key[0]}-measure{key[1]}"


def parse_state_key(name: str) -> AggKey:
    """Inverse of ``state_key``; accepts legacy ``"<agg>_<measure>"`` keys."""
    m = _STATE_KEY_RE.match(name)
    if m:
        return (int(m.group(1)), int(m.group(2)))
    agg, sep, mea = name.partition("_")
    if sep and agg.isdigit() and mea.isdigit():  # pre-store checkpoints
        return (int(agg), int(mea))
    raise ValueError(f"unrecognized synopsis state key: {name!r}")


def group_rows(snippets: SnippetBatch) -> List[Tuple[AggKey, np.ndarray]]:
    """(key, row-index array) per aggregate-function group, in key order."""
    agg = to_numpy(snippets.agg)
    mea = to_numpy(snippets.measure)
    keys = sorted({agg_key(a, m) for a, m in zip(agg, mea)})
    out = []
    for key in keys:
        rows = np.where(
            (agg == key[0]) & ((mea == key[1]) if key[0] == AVG else True)
        )[0]
        out.append((key, rows))
    return out


class SynopsisStore:
    """Base store: local placement plus all placement-oblivious machinery.

    ``device``: where improved answers are assembled (and, for the local
    store, where every synopsis lives). Subclasses override the placement
    hooks (``shard_index``/``device_for``/``describe_placement``), the
    dispatch grouping (``_dispatch_sets``) and optionally ``drain``.
    """

    kind = "local"

    def __init__(self, schema, config, device=None):
        self.schema = schema
        self.config = config
        self.device = resolve_device(device)
        self._synopses: Dict[AggKey, Synopsis] = {}

    # ------------------------------------------------------------ mapping
    def keys(self):
        return self._synopses.keys()

    def values(self):
        return self._synopses.values()

    def items(self):
        """``(key, synopsis)`` pairs."""
        return self._synopses.items()

    def get(self, key: AggKey) -> Optional[Synopsis]:
        return self._synopses.get(key)

    def generation(self, key: AggKey) -> int:
        """Monotone state generation of ``key``'s synopsis (0 if absent):
        the answer cache's staleness primitive (``repro_torch.intel``)."""
        syn = self._synopses.get(key)
        return syn.generation if syn is not None else 0

    def __len__(self) -> int:
        return len(self._synopses)

    def __contains__(self, key: AggKey) -> bool:
        return key in self._synopses

    def __iter__(self) -> Iterator[AggKey]:
        return iter(self._synopses)

    # ---------------------------------------------------------- placement
    def shard_index(self, key: AggKey) -> int:
        """Deterministic shard of ``key`` (0 when unsharded): a function of
        the key and the placement width only, so ``Session.explain`` can
        report it for keys that do not exist yet."""
        return 0

    def device_for(self, key: AggKey) -> torch.device:
        """Device the key's synopsis lives on."""
        return self.device

    def describe_placement(self, key: AggKey) -> str:
        return "local"

    def placement(self) -> Dict[AggKey, str]:
        """Key → human-readable placement for every existing synopsis."""
        return {k: self.describe_placement(k) for k in sorted(self._synopses)}

    # -------------------------------------------------------------- lookup
    def for_key(self, key: AggKey) -> Synopsis:
        """The synopsis for one aggregate-function key, created on demand
        on ``device_for(key)``."""
        syn = self._synopses.get(key)
        if syn is None:
            cfg = self.config
            syn = Synopsis(
                self.schema,
                capacity=cfg.capacity,
                delta_v=cfg.delta_v,
                async_ingest=cfg.async_ingest,
                max_pending=cfg.ingest_max_pending,
                min_fill_bucket=cfg.min_fill_bucket,
                min_q_bucket=cfg.min_q_bucket,
                device=self.device_for(key),
            )
            syn.name = state_key(key)  # fault-injection / telemetry identity
            self._synopses[key] = syn
        return syn

    # ------------------------------------------------------------- improve
    def _dispatch_sets(self, groups: Sequence[tuple]) -> List[List[tuple]]:
        """Group improvable ``(key, synopsis, rows)`` triples by device (the
        local store has one). Each synopsis still launches
        ``gp_batch_infer`` once: the reference's stacked dispatch has no
        copy here."""
        return [list(groups)] if groups else []

    def improve_groups(self, snippets: SnippetBatch, raw: RawAnswer,
                       use_kernels: bool = False,
                       health: Optional[dict] = None) -> ImprovedAnswer:
        """Per-aggregate-key improvement, scattered back to query order.

        One ``Synopsis.improve`` (one ``gp_batch_infer`` launch on the key's
        device) per aggregate key present in ``snippets``. A QUARANTINED
        synopsis is skipped exactly like an empty one — its rows keep the
        raw sample estimate (Theorem 1's floor) — and, when the caller
        passes a ``health`` dict, gains an entry ``{state_key: quarantine
        reason}``.
        """
        theta = to_numpy(raw.theta)
        beta2 = to_numpy(raw.beta2)
        out_theta = np.array(theta)
        out_beta2 = np.array(beta2)
        accepted = np.zeros(theta.shape[0], dtype=bool)
        groups = []
        for key, rows in group_rows(snippets):
            syn = self.for_key(key)
            with tracing.span("store.drain_wait"):
                syn.drain()
            if syn.quarantined:
                if health is not None:
                    health[state_key(key)] = syn.quarantine_reason
                continue  # degrade: raw floor for this group's rows
            if syn.n == 0:
                continue  # Theorem 1 equality case: raw passes through
            groups.append((key, syn, rows))
        for dispatch in self._dispatch_sets(groups):
            for _, syn, rows in dispatch:
                imp = syn.improve(
                    snippets[rows],
                    RawAnswer(torch.as_tensor(theta[rows], device=syn.device),
                              torch.as_tensor(beta2[rows], device=syn.device)),
                    use_kernel=use_kernels,
                )
                out_theta[rows] = to_numpy(imp.theta)
                out_beta2[rows] = to_numpy(imp.beta2)
                accepted[rows] = to_numpy(imp.accepted)
        return ImprovedAnswer(
            theta=torch.as_tensor(out_theta, dtype=F64, device=self.device),
            beta2=torch.as_tensor(out_beta2, dtype=F64, device=self.device),
            raw_theta=raw.theta,
            raw_beta2=raw.beta2,
            accepted=torch.as_tensor(accepted, device=self.device),
        )

    # -------------------------------------------------------------- record
    def record(self, snippets: SnippetBatch, raw: RawAnswer):
        """Enqueue final raw answers for learning (async per synopsis)."""
        theta = to_numpy(raw.theta)
        beta2 = to_numpy(raw.beta2)
        for key, rows in group_rows(snippets):
            self.for_key(key).add(snippets[rows], theta[rows], beta2[rows])

    # ----------------------------------------------------------- lifecycle
    def drain(self):
        """Barrier over every synopsis' async ingest queue."""
        for syn in self._synopses.values():
            syn.drain()

    def refit(self, steps: int = 150, lr: float = 0.1,
              learn_sigma: bool = False):
        """Offline learning pass (paper Algorithm 1) over every synopsis, in
        turn, each on its own device. Drains async ingest."""
        for syn in self._synopses.values():
            syn.refit(steps=steps, lr=lr, learn_sigma=learn_sigma)

    def ingest_stats(self) -> Dict[str, dict]:
        """Per-synopsis async-ingest back-pressure telemetry, keyed by the
        structured ``state_key`` form."""
        return {
            state_key(key): self._synopses[key].ingest_stats()
            for key in sorted(self._synopses)
        }

    # --------------------------------------------------------------- health
    def quarantined(self) -> Dict[str, str]:
        """``{state_key: reason}`` for every quarantined synopsis ({} when
        healthy) — the view behind ``Session.stats()["health"]``."""
        return {
            state_key(key): syn.quarantine_reason
            for key, syn in sorted(self._synopses.items())
            if syn.quarantined
        }

    def heal(self, states: Optional[Dict[str, dict]] = None) -> Dict[str, bool]:
        """Heal every quarantined synopsis; returns ``{state_key: healed}``.

        ``states``: an optional store-level ``state_dict`` payload — keys
        present there heal from the last-good snapshot then replay parked
        batches; keys absent heal via ``rebuild()`` from their own rows.
        """
        out: Dict[str, bool] = {}
        for key, syn in sorted(self._synopses.items()):
            if not syn.quarantined:
                continue
            name = state_key(key)
            state = states.get(name) if states is not None else None
            if state is not None:
                state = dict(state)
                state.pop("shard", None)
            out[name] = syn.heal(state)
        return out

    def stats(self) -> dict:
        """Operator-facing snapshot: placement, occupancy, back-pressure."""
        keys = {}
        for key in sorted(self._synopses):
            syn = self._synopses[key]
            keys[state_key(key)] = {
                "n": syn.n,
                "capacity": syn.capacity,
                "shard": self.shard_index(key),
                "placement": self.describe_placement(key),
                "ingest": syn.ingest_stats(),
            }
        return {"kind": self.kind, "n_shards": 1, "n_keys": len(keys),
                "keys": keys, "quarantined": self.quarantined()}

    # ------------------------------------------------------------- persist
    def state_dict(self) -> Dict[str, dict]:
        """Host snapshot of every synopsis, keyed by ``state_key``, with the
        ``shard`` tag of where it lived. Quarantined synopses are skipped
        with a warning."""
        out = {}
        for key in sorted(self._synopses):
            syn = self._synopses[key]
            if syn.quarantined:
                warnings.warn(
                    f"skipping quarantined synopsis {state_key(key)} in "
                    f"state_dict (heal() to rejoin): {syn.quarantine_reason}",
                    RuntimeWarning, stacklevel=2,
                )
                continue
            sd = syn.state_dict()
            sd["shard"] = np.asarray(self.shard_index(key), np.int64)
            out[state_key(key)] = sd
        return out

    def load_state_dict(self, state: Dict[str, dict]):
        """Restore synopses saved by either package's ``state_dict``;
        ``shard`` tags are ignored in favour of this store's placement."""
        for name, sd in state.items():
            sd = dict(sd)
            sd.pop("shard", None)
            self.for_key(parse_state_key(name)).load_state_dict(sd)


class LocalSynopsisStore(SynopsisStore):
    """Default store: every synopsis on the engine's device."""


class ShardedSynopsisStore(SynopsisStore):
    """Per-aggregate-key synopsis placement over the devices of a mesh.

    ``mesh``: a ``repro_torch.aqp.executor.Mesh`` (the same object shards
    the scan). ``devices`` overrides the mesh's device list (re-placing a
    checkpoint onto a subset); with neither, every visible CUDA card, and
    no card is an error. A device listed several times is several shards
    on one device. ``shard_index`` is a hash of the key modulo the device
    count, so a checkpoint re-places onto any mesh with no table to
    persist.
    """

    kind = "sharded"

    def __init__(self, schema, config, mesh=None, devices=None):
        if devices is None:
            devices = (mesh.devices if mesh is not None else
                       [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())])
        if not len(devices):
            raise ValueError("ShardedSynopsisStore needs at least one device "
                             "(no mesh, no devices and no CUDA card)")
        self.devices = [resolve_device(d) for d in devices]
        super().__init__(schema, config, self.devices[0])

    # ---------------------------------------------------------- placement
    def shard_index(self, key: AggKey) -> int:
        return (int(key[0]) * 8191 + int(key[1])) % len(self.devices)

    def device_for(self, key: AggKey) -> torch.device:
        return self.devices[self.shard_index(key)]

    def describe_placement(self, key: AggKey) -> str:
        i = self.shard_index(key)
        return f"shard{i}:{self.devices[i]}"

    # ------------------------------------------------------------ improve
    def _dispatch_sets(self, groups: Sequence[tuple]) -> List[List[tuple]]:
        """One set per device, in device order."""
        by_dev: Dict[int, List[tuple]] = {}
        for key, syn, rows in groups:
            by_dev.setdefault(self.shard_index(key), []).append(
                (key, syn, rows))
        return [by_dev[i] for i in sorted(by_dev)]

    # ----------------------------------------------------------- lifecycle
    def drain(self):
        """Parallel barrier: one waiter thread per occupied shard drains
        that shard's synopses. Never raises: an ingest failure quarantines
        the one affected synopsis."""
        by_shard: Dict[int, List[Synopsis]] = {}
        for key, syn in self._synopses.items():
            by_shard.setdefault(self.shard_index(key), []).append(syn)
        if len(by_shard) <= 1:
            for syns in by_shard.values():
                for syn in syns:
                    syn.drain()
            return

        def wait(shard):
            for syn in by_shard[shard]:
                syn.drain()  # quarantines on failure; never raises

        threads = [threading.Thread(target=wait, args=(s,), daemon=True)
                   for s in sorted(by_shard)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def stats(self) -> dict:
        out = super().stats()
        occupancy = [{"device": str(d), "n_keys": 0, "fill": 0}
                     for d in self.devices]
        for key, syn in self._synopses.items():
            shard = occupancy[self.shard_index(key)]
            shard["n_keys"] += 1
            shard["fill"] += syn.n
        out["n_shards"] = len(self.devices)
        out["shards"] = occupancy
        return out
