"""Interleaved-rANS entropy coder: ``ref.py`` (plain PyTorch), ``rans.py``
(kernels B7 encode, B3 v1 decode and B6 v0 decode in ``csrc/rans.cu``) and
``ops.py`` (padding, stream pack and parse, dispatch)."""

from repro_torch.kernels.entropy.ops import (  # noqa: F401
    HEADER_BYTES,
    decode_payloads,
    encode_payloads,
    entropy_traffic,
    rows_for,
)
