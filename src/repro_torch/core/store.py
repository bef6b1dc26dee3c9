"""SynopsisStore: the home of ALL learned state (local placement).

The query lifecycle (``repro_torch.aqp.plan``) talks to the store and never
to raw ``Synopsis`` dicts. Store protocol:

- ``for_key(key)`` — per-aggregate-key synopsis lookup, created on demand
  on the store's device; ``items()`` lists them;
- ``improve_groups(snippets, raw)`` — the per-aggregate-key improvement of a
  mixed snippet batch, scattered back to query order (Algorithm 2 lines
  3-7): one ``gp_batch_infer`` launch per aggregate key, as the reference's
  kernel branch does;
- ``record(snippets, raw)`` — enqueue final raw answers for learning
  (async per synopsis);
- ``drain`` / ``ingest_stats`` / ``heal``;
- ``state_dict`` / ``load_state_dict`` — ``"agg<k>-measure<m>"``-keyed
  numpy payloads in the reference's layout, so a JAX engine's
  ``synopses_state_dict()`` loads here as it is.
"""
from __future__ import annotations

import re
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.synopsis import Synopsis
from repro_torch.core.types import (
    AVG,
    F64,
    ImprovedAnswer,
    RawAnswer,
    SnippetBatch,
    to_numpy,
)

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
    """Per-aggregate-key synopses on one device (``device``)."""

    def __init__(self, schema, config, device):
        self.schema = schema
        self.config = config
        self.device = torch.device(device)
        self._synopses: Dict[AggKey, Synopsis] = {}

    def items(self):
        """``(key, synopsis)`` pairs."""
        return self._synopses.items()

    # -------------------------------------------------------------- lookup
    def for_key(self, key: AggKey) -> Synopsis:
        """The synopsis for one aggregate-function key, created on demand."""
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
                device=self.device,
            )
            syn.name = state_key(key)  # fault-injection / telemetry identity
            self._synopses[key] = syn
        return syn

    # ------------------------------------------------------------- improve
    def improve_groups(self, snippets: SnippetBatch, raw: RawAnswer,
                       use_kernels: bool = False,
                       health: Optional[dict] = None) -> ImprovedAnswer:
        """Per-aggregate-key improvement, scattered back to query order.

        One ``Synopsis.improve`` (one ``gp_batch_infer`` launch) per
        aggregate key present in ``snippets``. A QUARANTINED synopsis is
        skipped exactly like an empty one — its rows keep the raw sample
        estimate (Theorem 1's floor) — and, when the caller passes a
        ``health`` dict, gains an entry ``{state_key: quarantine reason}``.
        """
        theta = to_numpy(raw.theta)
        beta2 = to_numpy(raw.beta2)
        out_theta = np.array(theta)
        out_beta2 = np.array(beta2)
        accepted = np.zeros(theta.shape[0], dtype=bool)
        for key, rows in group_rows(snippets):
            syn = self.for_key(key)
            syn.drain()
            if syn.quarantined:
                if health is not None:
                    health[state_key(key)] = syn.quarantine_reason
                continue  # degrade: raw floor for this group's rows
            if syn.n == 0:
                continue  # Theorem 1 equality case: raw passes through
            imp = syn.improve(
                snippets[rows],
                RawAnswer(torch.as_tensor(theta[rows], device=self.device),
                          torch.as_tensor(beta2[rows], device=self.device)),
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

    def ingest_stats(self) -> Dict[str, dict]:
        """Per-synopsis async-ingest back-pressure telemetry, keyed by the
        structured ``state_key`` form."""
        return {
            state_key(key): self._synopses[key].ingest_stats()
            for key in sorted(self._synopses)
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

    # ------------------------------------------------------------- persist
    def state_dict(self) -> Dict[str, dict]:
        """Host snapshot of every synopsis, keyed by ``state_key``, with a
        ``shard`` tag (always 0 here) as the reference writes it.
        Quarantined synopses are skipped with a warning."""
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
            sd["shard"] = np.asarray(0, np.int64)
            out[state_key(key)] = sd
        return out

    def load_state_dict(self, state: Dict[str, dict]):
        """Restore synopses saved by either package's ``state_dict``;
        ``shard`` tags are ignored."""
        for name, sd in state.items():
            sd = dict(sd)
            sd.pop("shard", None)
            self.for_key(parse_state_key(name)).load_state_dict(sd)


class LocalSynopsisStore(SynopsisStore):
    """Default store: every synopsis on the engine's device."""
