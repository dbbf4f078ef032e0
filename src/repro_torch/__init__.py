"""PyTorch + CUDA port of the Salient Store archive (reference: ``repro``).

The port imports nothing of JAX or of the ``repro`` package.  Its kernels
are hand-written CUDA C++ for Hopper (``csrc/``), built with nvcc at first
use; entry points run on the card unless the caller passes ``device="cpu"``.
"""

from repro_torch.kernels import resolve_device  # noqa: F401
