"""Exact fp32 and the device every entry point runs on.

The JAX package pins full-fp32 matmuls with ``Precision.HIGHEST``; the
PyTorch counterpart is turning TF32 off.  PyTorch lets cuDNN convolutions
use TF32 by default, which keeps about three decimal digits: with
``peak_threshold = 0`` the extremum test fires on that rounding noise
(1968 "features" against 189 on an exact fp32 pyramid, see the JAX
package's ``ops/filters.py:49-56``).  ``exact_fp32`` states and sets both
switches; ``resolve_device`` calls it, so every entry point runs exact.
"""

from __future__ import annotations

import torch


def exact_fp32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is requested and absent: the port never
    carries on on the CPU by itself."""
    exact_fp32()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "niftymatch_torch entry points run on CUDA by default and no "
            "CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
