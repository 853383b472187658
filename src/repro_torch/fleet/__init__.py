"""repro_torch.fleet — fleet-scale replay serving.

Counterpart of ``repro/fleet``: a ``ReplicaPool`` of replay replicas
(each booted warm from the registry through its own client) behind an
admission-controlled ``LoadBalancer``, driven by a deterministic
open-loop ``OpenLoopTraffic`` generator on a virtual tick clock.  Built
via ``Workspace.fleet(...)``; run from the command line by
``repro_torch.launch.fleet``.
"""
from repro_torch.fleet.balancer import POLICIES, LoadBalancer
from repro_torch.fleet.pool import Replica, ReplicaPool
from repro_torch.fleet.traffic import Arrival, OpenLoopTraffic, TenantMix

__all__ = ["Arrival", "LoadBalancer", "OpenLoopTraffic", "POLICIES",
           "Replica", "ReplicaPool", "TenantMix"]
