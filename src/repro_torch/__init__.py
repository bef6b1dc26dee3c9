"""PyTorch/CUDA port of the Verdict database-learning engine.

A second package beside the JAX reference ``repro``, with the same layout:
``aqp`` (relation, sampler, queries, scan executor, plan IR, batch
executor), ``core`` (types, covariance, validation, synopsis, store,
engine), ``kernels`` (hand-written CUDA kernels with their plain PyTorch
versions) and ``ft`` (fault injection). It imports ``torch`` and numpy,
never ``jax`` and never ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``::

    from repro_torch.aqp.workload import tpch_like, tpch_workload
    from repro_torch.core.engine import EngineConfig, VerdictEngine

    rel = tpch_like(0, n_rows=6_001_215)           # on the card
    eng = VerdictEngine(rel, EngineConfig())
    res = eng.execute(tpch_workload(1, rel.schema, 1)[0],
                      target_rel_error=0.02)
"""
