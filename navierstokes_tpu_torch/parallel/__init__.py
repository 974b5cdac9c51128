"""The cell-loop operators on one device; the multi-device layer
(ROADMAP item 15) is not ported yet."""

from navierstokes_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedCellOperator,
    device_mesh,
)
