"""Public driver-level API of the port::

    import repro_torch.verdict as vd
    from repro_torch.aqp.workload import tpch_like

    rel = tpch_like(0, n_rows=6_001_215)          # on the card
    session = vd.connect(rel, vd.EngineConfig(sample_rate=0.1))
    q = session.query().avg("extendedprice").where(
        vd.between("ship_date", 0, 400))
    print(session.explain(q))
    answer = session.execute(q, vd.ErrorBudget(target_rel_error=0.02))
    for partial in session.stream(q):          # online aggregation
        print(partial.max_rel_error(), partial.final)

    mesh = vd.Mesh((rel.device,) * 4)          # four shards on one card
    sharded = vd.connect(rel, vd.EngineConfig(sample_rate=0.1), mesh=mesh)

    cached = vd.connect(rel, vd.EngineConfig(sample_rate=0.1), cache=True)
    cached.execute(q).served_from              # None: executed
    cached.execute(q).served_from              # "cache:exact": no scan

See ``repro_torch.verdict.session`` for the Session surface.
"""
from repro_torch.aqp.executor import Mesh
from repro_torch.core.engine import EngineConfig
from repro_torch.core.store import (
    LocalSynopsisStore,
    ShardedSynopsisStore,
    SynopsisStore,
)
from repro_torch.intel import IntelConfig, WorkloadIntel
from repro_torch.verdict.answer import Cell, FailedAnswer, PlanReport, QueryAnswer
from repro_torch.verdict.query import (
    QueryBuilder,
    any_of,
    between,
    equals,
    matches,
    one_of,
)
from repro_torch.verdict.session import ErrorBudget, Session, connect

__all__ = [
    "Cell",
    "EngineConfig",
    "ErrorBudget",
    "FailedAnswer",
    "IntelConfig",
    "LocalSynopsisStore",
    "Mesh",
    "PlanReport",
    "QueryAnswer",
    "QueryBuilder",
    "Session",
    "ShardedSynopsisStore",
    "SynopsisStore",
    "WorkloadIntel",
    "any_of",
    "between",
    "connect",
    "equals",
    "matches",
    "one_of",
]
