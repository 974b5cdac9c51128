"""IO: checkpoint / resume of transient solver state."""

from navierstokes_tpu_torch.io.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
