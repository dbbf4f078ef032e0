"""ChaCha20 stream cipher in plain PyTorch (RFC 8439 dataflow).

Port of ``repro.core.crypto.chacha``.  The round function works on 16
"planes" of equal shape, one per state word, so the whole permutation is
elementwise arithmetic over any batch of blocks.

PyTorch on the CPU implements few operations for ``torch.uint32`` (no
``+``, shifts or compares), so the planes carry each u32 word in an int64
tensor masked with ``0xFFFFFFFF`` after every add and shift; words enter
and leave as ``torch.uint32``.  The CUDA kernel (``csrc/seal.cu``) runs the
same rounds on native ``uint32_t``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = [
    "CONSTANTS",
    "M32",
    "chacha_rounds_planes",
    "chacha20_block",
    "keystream",
    "xor_stream",
    "bucket_n_words",
    "u32_to_i64",
    "i64_to_u32",
]

CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"
M32 = 0xFFFFFFFF

_COLUMN_IX = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15))
_DIAG_IX = ((0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def _quarter(x: List[torch.Tensor], ia: int, ib: int, ic: int, id_: int) -> None:
    a, b, c, d = x[ia], x[ib], x[ic], x[id_]
    a = (a + b) & M32
    d = _rotl(d ^ a, 16)
    c = (c + d) & M32
    b = _rotl(b ^ c, 12)
    a = (a + b) & M32
    d = _rotl(d ^ a, 8)
    c = (c + d) & M32
    b = _rotl(b ^ c, 7)
    x[ia], x[ib], x[ic], x[id_] = a, b, c, d


def chacha_rounds_planes(state: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """20 ChaCha rounds + feed-forward on 16 int64 planes holding u32 words."""
    x = list(state)
    for _ in range(10):
        for ix in _COLUMN_IX:
            _quarter(x, *ix)
        for ix in _DIAG_IX:
            _quarter(x, *ix)
    return [(xi + si) & M32 for xi, si in zip(x, state)]


def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """u32 words (any integer dtype) as int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 words -> ``torch.uint32`` modulo 2^32, through int32 (the
    conversions PyTorch implements for ``uint32`` on every device)."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(torch.int32).view(torch.uint32)


def chacha20_block(key: torch.Tensor, counter: torch.Tensor,
                   nonce: torch.Tensor) -> torch.Tensor:
    """key (8,), counter (B,), nonce (3,) u32 words -> (B, 16) torch.uint32."""
    counter = u32_to_i64(torch.atleast_1d(counter))
    key = u32_to_i64(key.to(counter.device))
    nonce = u32_to_i64(nonce.to(counter.device))
    B = counter.shape[0]
    state = (
        [torch.full((B,), c, dtype=torch.int64, device=counter.device) for c in CONSTANTS]
        + [key[i].expand(B) for i in range(8)]
        + [counter]
        + [nonce[i].expand(B) for i in range(3)]
    )
    return i64_to_u32(torch.stack(chacha_rounds_planes(state), dim=-1))


def keystream(key: torch.Tensor, nonce: torch.Tensor, n_words: int,
              counter0: int = 0) -> torch.Tensor:
    """(n_words,) torch.uint32 keystream: word w is word w%16 of block
    counter0 + w//16."""
    n_blocks = (n_words + 15) // 16
    counters = counter0 + torch.arange(n_blocks, dtype=torch.int64, device=key.device)
    return chacha20_block(key, counters, nonce).reshape(-1)[:n_words]


def bucket_n_words(n: int) -> int:
    """Smallest power of two >= max(n, 16) (the reference's keystream
    bucket; kept so callers that size buffers by it agree)."""
    return max(16, 1 << (int(n) - 1).bit_length())


def xor_stream(key: torch.Tensor, nonce: torch.Tensor, data_u32: torch.Tensor,
               counter0: int = 0) -> torch.Tensor:
    """XOR u32 words with the keystream (encrypt == decrypt), same shape."""
    flat = u32_to_i64(data_u32.reshape(-1))
    ks = u32_to_i64(keystream(key, nonce, flat.shape[0], counter0))
    return i64_to_u32(flat ^ ks).reshape(data_u32.shape)
