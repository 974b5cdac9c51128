"""Dtype and device policy (counterpart of ``navierstokes_tpu/config.py``).

* On the CPU every device array is float64, so the port can be held to the
  JAX package (run with x64 in its tests) at roundoff.
* On CUDA the caller picks float32 or float64; the H100 has hardware f64.
  ``NS_TPU_X64=1`` makes float64 the CUDA default as well.
* Entry points run on the card unless the caller passes ``device="cpu"``;
  with no CUDA device they raise instead of falling back to the CPU.

Importing this module turns TF32 off for matmuls and cuDNN: the convection
quadrature is a chain of einsum contractions, and TF32 keeps about three
decimal digits, which would cost three digits of every f32 step.
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FLOAT_DTYPES = (torch.float32, torch.float64)


def resolve_device(device=None) -> torch.device:
    """``torch.device`` of ``device`` (``None`` means the card, ``cuda``)."""
    return torch.device("cuda" if device is None else device)


def require_device(device=None) -> torch.device:
    """:func:`resolve_device`, raising ``RuntimeError`` for a CUDA device
    when no card is present (the CPU is used only when asked for)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default) but torch.cuda."
            "is_available() is False; pass device='cpu' to run on the CPU")
    return dev


def default_dtype(device=None) -> torch.dtype:
    """Storage dtype of device arrays made on ``device``."""
    if resolve_device(device).type == "cpu":
        return torch.float64
    if os.environ.get("NS_TPU_X64", "").lower() in ("1", "true", "yes"):
        return torch.float64
    return torch.float32


def resolve_dtype(dtype, device=None) -> torch.dtype:
    """``dtype`` checked against the supported floats, or the default."""
    dt = default_dtype(device) if dtype is None else dtype
    if dt not in FLOAT_DTYPES:
        raise TypeError(f"unsupported dtype {dt}: expected float32 or "
                        "float64")
    return dt


def numpy_dtype(dtype: torch.dtype):
    """The NumPy dtype with the same width as a torch float dtype."""
    import numpy as np

    return np.float64 if dtype == torch.float64 else np.float32
