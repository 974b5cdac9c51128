"""The multi-device layer in one process: a mesh of shard devices and its
collectives (``comm``), cell-sharded operators with replicated vectors
(``sharded``), dof-partitioned operators with halo exchange (``halo``) and
the cell-sharded mixed residual and Jacobian of the Newton stack
(``sharded_mixed``)."""

from navierstokes_tpu_torch.parallel.comm import (  # noqa: F401
    DeviceMesh,
    device_mesh,
)
from navierstokes_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedCellOperator,
)
