"""Hand-written Hopper kernels of the port and the helpers their ops share.

Each kernel package keeps the reference's three parts: ``ref.py`` (plain
PyTorch, the port's own oracle), ``<name>.py`` (the ctypes wrapper of the
CUDA source in ``repro_torch/csrc``, built by ``_build``), and ``ops.py``
(the public functions).  A wrapper picks by the device of the tensor it is
given: a CPU tensor goes to the plain version, a CUDA tensor to the kernel,
which launches or raises.  Nothing moves a CUDA tensor to the CPU to compute.

Entry points take ``device=``; ``None`` means CUDA, and raises when CUDA is
absent.  Pass ``device="cpu"`` for the plain path, as the tests do.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "as_payload_list"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (array-like or tensor) as a ``dtype`` tensor on ``device``.

    A tensor that lies on a CUDA device is never brought to the CPU: asking
    for that raises, so a CPU entry point cannot quietly take over card data.
    """
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda" and device.type != "cuda":
            raise ValueError(f"tensor lies on {x.device}; pass device='cuda'")
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def as_payload_list(payloads, device: torch.device) -> List[torch.Tensor]:
    """Ragged stripe payloads (list/tuple, or a stacked (S, N) array) as a
    list of flat int8 tensors on ``device``."""
    if isinstance(payloads, (list, tuple)):
        return [as_tensor(p, torch.int8, device).reshape(-1) for p in payloads]
    arr = as_tensor(payloads, torch.int8, device)
    return [arr[s].reshape(-1) for s in range(arr.shape[0])]
