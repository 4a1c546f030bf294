"""Mesh plumbing + sharded functions (reference:
``trivy_tpu/parallel``).

The work splits over a ``(data, rules)`` grid of devices
(``mesh.DeviceMesh``):

  - ``data`` axis: segments / files / packages — batch-dimension data
    parallelism, one launch per shard on its device;
  - ``rules`` axis: literal code chunks — the per-rule-shard masks
    rejoin by concatenation along the code axis.

One process launches every shard of its mesh itself, each on a side
stream of its device behind its own event, so nothing here needs a
collective; ``multihost`` joins several processes, each with its own
mesh, and splits the fleet between them.
"""

from .interval_shard import (sharded_interval_hits,
                             sharded_interval_hits_resident)
from .mesh import make_mesh, mesh_axis_sizes
from .multihost import (HostTopology, global_mesh,
                        host_shard_layout, initialize,
                        local_indices, topology_from_env)
from .secret_shard import sharded_blockmask

__all__ = ["HostTopology", "global_mesh", "host_shard_layout",
           "initialize", "local_indices", "make_mesh",
           "mesh_axis_sizes", "sharded_blockmask",
           "sharded_interval_hits", "sharded_interval_hits_resident",
           "topology_from_env"]
