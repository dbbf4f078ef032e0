"""Byte-level entropy stage: zstd when available, stdlib zlib fallback.

The port's own copy of ``repro.common.compress`` (the port imports nothing
of ``repro``).

``zstandard`` is an optional dependency (the paper's own entropy coder); on
hosts without it the archival/checkpoint paths degrade to zlib rather than
failing at import.  Within one host the choice is deterministic, so blobs
written by ``compress`` always round-trip through ``decompress``.

``compress_as`` / ``decompress_as`` take the codec *by name* for callers
that persist it (archive manifests, checkpoint metadata): zlib is stdlib
and therefore always readable/writable, zstd only when the module exists —
so a blob recorded as "zlib" stays decodable on every host, including ones
that prefer zstd.
"""

from __future__ import annotations

import zlib as _zlib

__all__ = [
    "HAVE_ZSTD",
    "CODEC_NAME",
    "compress",
    "decompress",
    "compress_as",
    "decompress_as",
]


def _zlib_compress(data: bytes, level: int = 3) -> bytes:
    # zstd levels go to 22; clamp into zlib's 0..9 range
    return _zlib.compress(data, min(level, 9))


def _zlib_decompress(blob: bytes, max_output_size: int = 0) -> bytes:
    if max_output_size:
        return _zlib.decompressobj().decompress(blob, max_output_size)
    return _zlib.decompress(blob)


try:
    import zstandard as _zstd

    HAVE_ZSTD = True
    CODEC_NAME = "zstd"

    def compress(data: bytes, level: int = 3) -> bytes:
        return _zstd.ZstdCompressor(level=level).compress(data)

    def decompress(blob: bytes, max_output_size: int = 0) -> bytes:
        return _zstd.ZstdDecompressor().decompress(
            blob, max_output_size=max_output_size
        )

except ImportError:  # also ModuleNotFoundError; lets tests block the import
    HAVE_ZSTD = False
    CODEC_NAME = "zlib"
    compress = _zlib_compress
    decompress = _zlib_decompress


def _dispatch(name: str):
    if name == "zlib":
        return _zlib_compress, _zlib_decompress
    if name == "zstd":
        if not HAVE_ZSTD:
            raise ValueError(
                "codec 'zstd' requires the zstandard module "
                "(install zstandard, or use 'zlib')"
            )
        return compress, decompress
    raise ValueError(f"unknown host entropy codec {name!r}")


def compress_as(name: str, data: bytes, level: int = 3) -> bytes:
    """Compress with the codec *named* ``name`` (not the host preference)."""
    return _dispatch(name)[0](data, level)


def decompress_as(name: str, blob: bytes, max_output_size: int = 0) -> bytes:
    """Decompress a blob recorded as written by codec ``name``."""
    return _dispatch(name)[1](blob, max_output_size)
