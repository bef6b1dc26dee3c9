"""Group-discovery kernel: each probe's group-by values among the tuples of
the first sample batch it admits, marked on the card (a presence table in
shared memory, or each tuple's code for a sort-unique), so that only the
marks cross to the host."""
from repro_torch.kernels.group_discovery.ops import (
    discovery_plan,
    distinct_keys,
    group_discovery,
)
from repro_torch.kernels.group_discovery.ref import group_discovery_ref

__all__ = ["discovery_plan", "distinct_keys", "group_discovery",
           "group_discovery_ref"]
