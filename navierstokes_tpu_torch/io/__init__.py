"""IO: field output and checkpoint / resume of transient solver state."""

from navierstokes_tpu_torch.io.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from navierstokes_tpu_torch.io.output import (  # noqa: F401
    FieldWriter,
    write_boundary_markers,
    write_vtu,
)
