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

import functools

import torch


def exact_fp32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f32(fn):
    """Run ``fn`` with TF32 off: the counterpart of the JAX package's
    ``@f32`` (``Precision.HIGHEST``) on the geometry functions, whose
    small products lose their null spaces in TF32."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        exact_fp32()
        return fn(*args, **kwargs)
    return wrapped


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


def device_constant(values, device, dtype=None) -> torch.Tensor:
    """A tensor of constant values (a list or numpy array) on ``device``
    without waiting on it.  ``torch.tensor(..., device="cuda")`` copies
    with a stream synchronisation, so the host waits for every queued
    kernel; a non-blocking copy of a host tensor is queued instead (CUDA
    stages pageable memory before the call returns)."""
    return torch.as_tensor(values, dtype=dtype).to(device, non_blocking=True)


def host_fetch(*tensors):
    """numpy copies of ``tensors`` after ONE wait on the device: every
    copy is queued without blocking (into pinned memory), then a single
    event synchronisation waits for all of them, where a ``.cpu()`` each
    would wait once per tensor."""
    cuda = [t for t in tensors if t.device.type == "cuda"]
    if not cuda:
        return [t.detach().numpy() for t in tensors]
    out = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(cuda[0].device))
    done.synchronize()
    return [t.numpy() for t in out]


# Field names of the port's state tuples (``Features``, ``BAProblem``,
# ``PoseGraph``, ``Sim3Graph``) that are not float32.
_FIELD_DTYPES = dict(
    octave=torch.int32, level=torch.int32, obs_cam=torch.int32, obs_lm=torch.int32,
    edge_i=torch.int32, edge_j=torch.int32, valid=torch.bool, obs_valid=torch.bool,
    pose_fixed=torch.bool, edge_valid=torch.bool, node_fixed=torch.bool)


def state_to(state, device):
    """The NamedTuple ``state`` (numpy arrays or tensors) with every field
    on ``device``: indices int32 and masks bool by field name, the rest
    float32."""
    return type(state)(*[
        torch.as_tensor(a, device=device).to(_FIELD_DTYPES.get(name, torch.float32))
        for name, a in zip(state._fields, state)
    ])
