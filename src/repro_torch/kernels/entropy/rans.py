"""Interleaved-rANS kernels (``csrc/rans.cu``) and their ctypes wrappers.

Port of the launch wrappers of ``repro.kernels.entropy.rans``:

* ``rans_encode_kernel`` (TPU kernel ``_encode_kernel``): per shard, the
  histogram of the valid bytes, the frequency table and the 128-lane encode,
  emitting the dense word buffer and emission mask that ``ops.py`` compacts;
* ``rans_decode_kernel`` (``_decode_kernel``): version-1 streams, words in
  row-major decoder-read order behind one pointer per shard;
* ``rans_decode_v0_kernel`` (``_decode_kernel_v0``): version-0 streams,
  lane-major word runs behind one pointer per lane.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  Operands (S shards, T rows of 128 lanes, W words):
codes (S, T, 128) int8; n_valid (S, 1) int32 valid bytes per shard; words
(S, T, 128) or stream (S, W) int16 holding u16 bits; mask (S, T, 128)
uint8; freq (S, 256) int32; states (S, 128) int32 holding u32 bits;
lane_lens (S, 128) int32.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.entropy import ref as _ref
from repro_torch.kernels.entropy.ref import N_LANES, T_TILE

__all__ = ["rans_encode_kernel", "rans_decode_kernel", "rans_decode_v0_kernel"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENCODE_ARGS = [_P, _P, _I, _I, _P, _P, _P, _P, _P]
_DECODE_ARGS = [_P, _I, _P, _P, _P, _I, _I, _P, _P]
_DECODE_V0_ARGS = [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P]


def _check_rows(T: int) -> None:
    if T <= 0 or T % T_TILE:
        raise ValueError(f"rows {T} not a positive multiple of {T_TILE}")


def _stream_operands(stream, freq, states, n_valid, rows: int):
    S, W = stream.shape
    dev = stream.device
    _check_rows(rows)
    if W < 1:
        raise ValueError("stream needs at least one word")
    _build.require(stream, "stream", torch.int16, (S, W), dev)
    _build.require(freq, "freq", torch.int32, (S, 256), dev)
    _build.require(states, "states", torch.int32, (S, N_LANES), dev)
    _build.require(n_valid, "n_valid", torch.int32, (S, 1), dev)
    return S, W, dev


def rans_encode_kernel(codes: torch.Tensor, n_valid: torch.Tensor):
    """Encode S shards in one launch -> (words, mask, freq, states).

    codes: (S, T, 128) int8, zero past each shard's n_valid; n_valid:
    (S, 1) int32.  Returns words (S, T, 128) int16, mask (S, T, 128) uint8,
    freq (S, 256) int32 and the final lane states (S, 128) int32.
    """
    if codes.device.type == "cpu":
        return _ref.rans_encode_ref(codes, n_valid)
    S, T, L = codes.shape
    dev = codes.device
    _check_rows(T)
    _build.require(codes, "codes", torch.int8, (S, T, N_LANES), dev)
    _build.require(n_valid, "n_valid", torch.int32, (S, 1), dev)
    words = torch.empty((S, T, N_LANES), dtype=torch.int16, device=dev)
    mask = torch.empty((S, T, N_LANES), dtype=torch.uint8, device=dev)
    freq = torch.empty((S, 256), dtype=torch.int32, device=dev)
    states = torch.empty((S, N_LANES), dtype=torch.int32, device=dev)
    launch = _build.function("rans", "rans_encode_launch", _ENCODE_ARGS)
    with torch.cuda.device(dev):  # the launch goes to the current device's context
        status = launch(codes.data_ptr(), n_valid.data_ptr(), S, T, words.data_ptr(),
                        mask.data_ptr(), freq.data_ptr(), states.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "rans_encode_launch")
    _build.LAUNCHES["rans_encode"] += 1
    return words, mask, freq, states


def rans_decode_kernel(stream: torch.Tensor, freq: torch.Tensor, states: torch.Tensor,
                       n_valid: torch.Tensor, *, rows: int) -> torch.Tensor:
    """Version-1 decode -> (S, rows, 128) int8 payload rows, zeros past
    n_valid.  stream: (S, W) int16 words in row-major decoder-read order."""
    if stream.device.type == "cpu":
        return _ref.rans_decode_ref(stream, freq, states, n_valid, rows=rows)
    S, W, dev = _stream_operands(stream, freq, states, n_valid, rows)
    out = torch.empty((S, rows, N_LANES), dtype=torch.int8, device=dev)
    launch = _build.function("rans", "rans_decode_launch", _DECODE_ARGS)
    with torch.cuda.device(dev):
        status = launch(stream.data_ptr(), W, freq.data_ptr(), states.data_ptr(),
                        n_valid.data_ptr(), S, rows, out.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "rans_decode_launch")
    _build.LAUNCHES["rans_decode"] += 1
    return out


def rans_decode_v0_kernel(stream: torch.Tensor, lane_lens: torch.Tensor, freq: torch.Tensor,
                          states: torch.Tensor, n_valid: torch.Tensor, *,
                          rows: int) -> torch.Tensor:
    """Version-0 decode -> (S, rows, 128) int8.  stream: (S, W) int16
    lane-major word runs; lane_lens: (S, 128) int32 run lengths."""
    if stream.device.type == "cpu":
        return _ref.rans_decode_ref_v0(stream, lane_lens, freq, states, n_valid, rows=rows)
    S, W, dev = _stream_operands(stream, freq, states, n_valid, rows)
    _build.require(lane_lens, "lane_lens", torch.int32, (S, N_LANES), dev)
    out = torch.empty((S, rows, N_LANES), dtype=torch.int8, device=dev)
    launch = _build.function("rans", "rans_decode_v0_launch", _DECODE_V0_ARGS)
    with torch.cuda.device(dev):
        status = launch(stream.data_ptr(), W, lane_lens.data_ptr(), freq.data_ptr(),
                        states.data_ptr(), n_valid.data_ptr(), S, rows, out.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "rans_decode_v0_launch")
    _build.LAUNCHES["rans_decode_v0"] += 1
    return out
