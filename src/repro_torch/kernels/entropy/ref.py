"""Plain PyTorch version of the interleaved-rANS coder (bit-exact target).

Port of the table builders and step functions of
``repro.kernels.entropy.rans`` and of the staged oracle
``repro.kernels.entropy.ref``.  A shard's flat int8 payload is laid out as
(T, 128) rows whose 128 columns are independent rANS lanes (lane l owns
bytes l, 128 + l, ...); 32-bit states, 16-bit renormalisation, 12-bit
frequency tables.  The coding loops run over rows in Python with the
(S, 128) lanes as one vector, as the reference's ``lax.scan`` does.

Words are carried as int64 masked to 32 bits (PyTorch has no ``+``,
shifts or compares for ``torch.uint32`` on the CPU).  The functions take
and give the kernels' operand types: codes int8, stream words int16 (the
bits of u16), emission mask uint8, frequencies int32 and lane states int32
(the bits of u32).  Runs on either device; on the card it is what
``chip_smoke.py`` holds the kernels against.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "N_LANES",
    "PROB_BITS",
    "PROB_SCALE",
    "RANS_L",
    "T_TILE",
    "STREAM_VERSION",
    "build_freq_table",
    "build_dec_table",
    "slot_to_symbol",
    "enc_step",
    "dec_step",
    "rans_encode_ref",
    "rans_decode_ref",
    "lane_major_words",
    "rans_decode_ref_v0",
]

N_LANES = 128                 # interleaved rANS lanes per shard
PROB_BITS = 12                # frequency table quantisation: sum(freq) = 4096
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 16              # state lower bound; 16-bit renormalisation
T_TILE = 8                    # row granularity of the coder's geometry
STREAM_VERSION = 1            # row-major word order; 0 = the older lane-major

M32 = 0xFFFFFFFF
_SYM_MASK = 0x1FFF            # 13 bits: freq and cum both reach 4096


def _unsigned(t: torch.Tensor, bits: int) -> torch.Tensor:
    """int16/int32 bit patterns -> int64 values of the unsigned type."""
    return t.to(torch.int64) & ((1 << bits) - 1)


def _signed(v: torch.Tensor, bits: int, dtype: torch.dtype) -> torch.Tensor:
    """int64 values of an unsigned type -> the signed type with the same bits."""
    v = v & ((1 << bits) - 1)
    return (v - ((v >> (bits - 1)) << bits)).to(dtype)


def build_freq_table(counts: torch.Tensor) -> torch.Tensor:
    """(..., 256) byte counts -> (..., 256) int32 freqs summing to PROB_SCALE.

    The reference's integer normalisation: counts shift right until their
    total is below 2^19, every present symbol gets one slot up front, the
    rest of the budget is floor-allocated in proportion, and the remainder
    goes to the first most frequent symbol.  Computed in int64, which equals
    the reference's int32 for count totals up to 2^24, the most one shard
    can hold (``ops.MAX_ROWS`` rows of 128 bytes).
    """
    counts = counts.to(torch.int64)
    present = (counts > 0).to(torch.int64)
    total = counts.sum(-1, keepdim=True)
    thresholds = 1 << torch.arange(19, 31, dtype=torch.int64, device=counts.device)
    shift = (total >= thresholds).sum(-1, keepdim=True)
    c2 = torch.maximum(counts >> shift, present)
    n2 = c2.sum(-1, keepdim=True).clamp(min=1)
    budget = PROB_SCALE - present.sum(-1, keepdim=True)
    extra = (c2 * budget) // n2
    freq = present + extra
    rem = budget - extra.sum(-1, keepdim=True)
    top = torch.nn.functional.one_hot(c2.argmax(-1), 256).to(torch.int64)
    return (freq + top * rem).to(torch.int32)


def _cum_excl(freq: torch.Tensor) -> torch.Tensor:
    f = freq.to(torch.int64)
    return f.cumsum(-1) - f


def build_dec_table(freq: torch.Tensor) -> torch.Tensor:
    """(..., 256) freqs -> packed decode table ``f | cum_excl << 13`` as u32
    values in int64."""
    return (_unsigned(freq, 32) | (_cum_excl(freq) << 13)) & M32


def slot_to_symbol(freq: torch.Tensor) -> torch.Tensor:
    """(S, 256) freqs -> (S, PROB_SCALE) int64 slot -> symbol table.

    Cumulative-bucket fill: each present symbol marks its start slot, and a
    running max floods it over [cum, cum + f).  A symbol with zero frequency
    shares its start slot with its successor and loses the max; slots before
    the first mark map to symbol 0.
    """
    S = freq.shape[0]
    start = torch.where(freq > 0, _cum_excl(freq), PROB_SCALE).clamp(max=PROB_SCALE)
    sym = torch.arange(256, dtype=torch.int64, device=freq.device).expand(S, 256)
    marks = torch.zeros((S, PROB_SCALE + 1), dtype=torch.int64, device=freq.device)
    marks = marks.scatter_reduce(1, start, sym, reduce="amax", include_self=True)
    return torch.cummax(marks[:, :PROB_SCALE], dim=1).values


def _enc_tables(freq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, 256) freqs -> (f clamped to >= 1, cum_excl), int64.  The clamp
    only matters for padding lanes, whose update is discarded."""
    return freq.to(torch.int64).clamp(min=1), _cum_excl(freq)


def enc_step(x: torch.Tensor, f: torch.Tensor, c: torch.Tensor):
    """One interleaved encode step -> (state', pre-renorm state, emitted).

    Renormalise first (shift out the low 16 bits when x >= f << 20, written
    as a shift-compare so f = PROB_SCALE cannot overflow), then
    x' = x + (x // f) * (PROB_SCALE - f) + cum, wrapping at 32 bits.
    """
    emit = (x >> 20) >= f
    x_pre = x
    x = torch.where(emit, x >> 16, x)
    q = x // f
    return (x + q * (PROB_SCALE - f) + c) & M32, x_pre, emit


def dec_step(x: torch.Tensor, dec_packed: torch.Tensor, slot2sym: torch.Tensor):
    """One interleaved decode step -> (pre-renorm state, symbol, needs a word).

    x: (S, 128) states; tables (S, 256) / (S, PROB_SCALE), gathered per lane.
    """
    slot = x & (PROB_SCALE - 1)
    s = torch.gather(slot2sym, 1, slot)
    p = torch.gather(dec_packed, 1, s)
    f = p & _SYM_MASK
    c = (p >> 13) & _SYM_MASK
    x = (f * (x >> PROB_BITS) + slot - c) & M32
    return x, s, x < RANS_L


def _valid(S: int, T: int, n_valid: torch.Tensor) -> torch.Tensor:
    """(S, T, 128) bool: position t*128 + l is a real (non-padding) byte."""
    pos = torch.arange(T * N_LANES, device=n_valid.device).reshape(1, T, N_LANES)
    return pos < n_valid.reshape(S, 1, 1).to(torch.int64)


def _histogram(codes: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """(S, T, 128) int8 codes -> (S, 256) int64 counts of the valid bytes."""
    S, T, L = codes.shape
    vals = (codes.to(torch.int64) & 0xFF).reshape(S, T * L)
    idx = torch.where(_valid(S, T, n_valid).reshape(S, T * L), vals, 256)
    counts = torch.zeros((S, 257), dtype=torch.int64, device=codes.device)
    return counts.scatter_add_(1, idx, torch.ones_like(idx))[:, :256]


def rans_encode_ref(codes: torch.Tensor, n_valid: torch.Tensor):
    """Encode S shards -> (words (S, T, 128) int16, mask (S, T, 128) uint8,
    freq (S, 256) int32, states (S, 128) int32).

    codes: (S, T, 128) int8; n_valid: (S, 1) int32 valid bytes per shard.
    Rows run in reverse.  At every position the word is the low 16 bits of
    the state before the step, and the mask says whether the step emitted
    it; past n_valid a lane's state is frozen and emits nothing.
    """
    S, T, L = codes.shape
    if L != N_LANES:
        raise ValueError(f"expected {N_LANES} lanes, got {L}")
    freq = build_freq_table(_histogram(codes, n_valid))
    f_tab, c_tab = _enc_tables(freq)
    vals = (codes.to(torch.int64) & 0xFF).reshape(S, T * L)
    f_pos = torch.gather(f_tab, 1, vals).reshape(S, T, L)
    c_pos = torch.gather(c_tab, 1, vals).reshape(S, T, L)
    valid = _valid(S, T, n_valid)
    x = torch.full((S, L), RANS_L, dtype=torch.int64, device=codes.device)
    words, mask = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        x2, x_pre, emit = enc_step(x, f_pos[:, t], c_pos[:, t])
        x = torch.where(valid[:, t], x2, x)
        words[t] = x_pre & 0xFFFF
        mask[t] = emit & valid[:, t]
    words = _signed(torch.stack(words, 1), 16, torch.int16)
    mask = torch.stack(mask, 1).to(torch.uint8)
    return words, mask, freq, _signed(x, 32, torch.int32)


def _decode_tables(freq: torch.Tensor):
    return build_dec_table(freq), slot_to_symbol(freq)


def _out_byte(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Decoded symbol byte -> int8 two's complement, zero past n_valid."""
    return torch.where(valid, s - ((s & 0x80) << 1), 0).to(torch.int8)


def rans_decode_ref(stream: torch.Tensor, freq: torch.Tensor, states: torch.Tensor,
                    n_valid: torch.Tensor, *, rows: int) -> torch.Tensor:
    """Version-1 decode -> (S, rows, 128) int8, zeros past n_valid.

    stream: (S, W) int16 words in row-major decoder-read order.  Per row,
    the lanes that need a word take the next ones off one per-shard stream
    pointer in lane order (exclusive prefix sum of the need flags); reads
    past the end clamp to word W - 1, as in the reference.
    """
    S, W = stream.shape
    words = _unsigned(stream, 16)
    dec_packed, slot2sym = _decode_tables(freq)
    valid = _valid(S, rows, n_valid)
    x = _unsigned(states, 32)
    base = torch.zeros((S, 1), dtype=torch.int64, device=stream.device)
    out = [None] * rows
    for t in range(rows):
        v = valid[:, t]
        x2, s, need = dec_step(x, dec_packed, slot2sym)
        need = need & v
        csum = need.to(torch.int64).cumsum(1)
        pos = base + csum - need.to(torch.int64)
        w = torch.gather(words, 1, pos.clamp(max=W - 1))
        x2 = torch.where(need, ((x2 << 16) | w) & M32, x2)
        x = torch.where(v, x2, x)
        base = base + csum[:, -1:]
        out[t] = _out_byte(s, v)
    return torch.stack(out, 1)


def lane_major_words(stream: torch.Tensor, lane_lens: torch.Tensor, rows: int) -> torch.Tensor:
    """Version-0 re-gather: (S, W) lane-major runs -> (S, rows, 128) int64,
    word j of lane l at [:, j, l] = stream[off(l) + j], the index clamped
    to [0, W - 1] (positions past a lane's run are never consumed)."""
    S, W = stream.shape
    lens = lane_lens.to(torch.int64)
    off = lens.cumsum(1) - lens
    j = torch.arange(rows, dtype=torch.int64, device=stream.device).reshape(1, rows, 1)
    idx = (off.reshape(S, 1, N_LANES) + j).clamp(0, W - 1).reshape(S, rows * N_LANES)
    return torch.gather(_unsigned(stream, 16), 1, idx).reshape(S, rows, N_LANES)


def rans_decode_ref_v0(stream: torch.Tensor, lane_lens: torch.Tensor, freq: torch.Tensor,
                       states: torch.Tensor, n_valid: torch.Tensor, *,
                       rows: int) -> torch.Tensor:
    """Version-0 decode -> (S, rows, 128) int8: lane-major word runs (lane
    l's run starts at the exclusive prefix of ``lane_lens``), one read
    pointer per lane, clamped to rows - 1."""
    S = stream.shape[0]
    lane_words = lane_major_words(stream, lane_lens, rows)
    dec_packed, slot2sym = _decode_tables(freq)
    valid = _valid(S, rows, n_valid)
    x = _unsigned(states, 32)
    ptr = torch.zeros((S, N_LANES), dtype=torch.int64, device=stream.device)
    out = [None] * rows
    for t in range(rows):
        v = valid[:, t]
        x2, s, need = dec_step(x, dec_packed, slot2sym)
        need = need & v
        w = torch.gather(lane_words, 1, ptr.clamp(max=rows - 1).unsqueeze(1)).squeeze(1)
        x2 = torch.where(need, ((x2 << 16) | w) & M32, x2)
        x = torch.where(v, x2, x)
        ptr = ptr + need.to(torch.int64)
        out[t] = _out_byte(s, v)
    return torch.stack(out, 1)
