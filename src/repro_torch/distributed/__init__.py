"""Placement over a ``Mesh`` with named axes (the reference's
``repro.distributed``): the logical-axis rules and sharding trees
(``sharding``) and the int8 cross-pod gradient exchange
(``compression``)."""
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    batch_axes,
    cache_shardings,
    data_shards,
    opt_state_shardings,
)

__all__ = ["DEFAULT_RULES", "batch_axes", "cache_shardings", "data_shards",
           "opt_state_shardings"]
