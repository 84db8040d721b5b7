"""A numpy model of the ALU probe's moves as csrc/exp_vpu.cu makes them,
held to the plain version (``ops.kernels.vpu_chain_plain``) on the CPU.

The model keeps a row's 32-bit words in (thread, slot) order, K
consecutive words a thread, T threads of one warp a row and 32 / T rows a
warp: each step every thread sends its last word (or, on a row that is not
K-aligned, the row's last word from its slot, where thread (W - 1) // K
holds it), a warp shuffle of width T hands thread t the word of thread
t - 1 and thread 0 that of thread (W - 1) // K (ROLL) or 1 (SHIFT), and the
slots take their left neighbours' old words from the last down, the int16
half-word carry by ``__byte_perm(prev, w, 0x5432)``.  Words past W are
dead, rows past R too.  Roll and shift, int32 and int16, at W = 32 K for
K = 1 .. 32 on a whole warp, at the layouts the kernel picks
(``kernels.vpu_layout``), at widths that are not K-aligned, and in the
sub-warp form of rows of up to 32 words.  Exact equality."""

import numpy as np
import pytest
import torch

from seqalign_tpu_torch.ops import kernels

STEPS = 37  # more than a short row's words: the roll wraps around
M32 = np.uint64(0xFFFFFFFF)


def _words(x):
    """(R, L) int32 or int16 lanes as (R, W) uint64 words: an int16 pair
    (2j, 2j+1) in the low and high halves of word j."""
    if x.dtype == np.int16:
        u = x.view(np.uint16).astype(np.uint64)
        return u[:, 0::2] | (u[:, 1::2] << np.uint64(16))
    return x.view(np.uint32).astype(np.uint64)


def _lanes(w, dtype):
    """The inverse of ``_words``."""
    if dtype == np.int16:
        lo = (w & np.uint64(0xFFFF)).astype(np.uint16)
        hi = (w >> np.uint64(16)).astype(np.uint16)
        return np.stack([lo, hi], -1).reshape(len(w), -1).view(np.int16)
    return w.astype(np.uint32).view(np.int32)


def _add(a, b, i16):
    """``a + b`` (int32) or ``__vadd2(a, b)`` (two int16 halves), each
    wrapping."""
    if not i16:
        return (a + b) & M32
    lo = (a + b) & np.uint64(0xFFFF)
    hi = ((a >> np.uint64(16)) + (b >> np.uint64(16))) & np.uint64(0xFFFF)
    return lo | (hi << np.uint64(16))


def _moved(prev, w, i16):
    """The word a slot takes from ``prev``, its left neighbour, before the
    add: ``prev`` (int32) or ``__byte_perm(prev, w, 0x5432)`` (int16: the
    high half of prev low, the low half of w high)."""
    if not i16:
        return prev
    return (prev >> np.uint64(16)) | ((w & np.uint64(0xFFFF))
                                      << np.uint64(16))


def move_model(x, steps, op, T, K):
    """``steps`` moves of the (R, L) block ``x`` in the kernel's order of
    work: a warp's 32 lanes as 32 / T groups of T threads, K words a
    thread."""
    i16 = x.dtype == np.int16
    R = x.shape[0]
    words = _words(x)
    W = words.shape[1]
    assert T * K >= W and 32 % T == 0
    per_warp = 32 // T
    warps = -(-R // per_warp)
    # registers by (warp, lane, slot); lane = group * T + t
    v = np.zeros((warps, 32, K), np.uint64)
    g = np.arange(warps * 32)
    row, t = g // T, g % T
    for k in range(K):
        j = t * K + k
        ok = (row < R) & (j < W)
        v.reshape(-1, K)[ok, k] = words[row[ok], j[ok]]
    w = v.copy()
    tl, sl = (W - 1) // K, (W - 1) % K
    lane = np.arange(32)
    tt = lane % T
    src = np.where(tt == 0, tl, tt - 1)
    shfl = (lane & ~(T - 1)) + src % T  # __shfl_sync(..., src, width T)
    for _ in range(steps):
        send = w[:, :, K - 1].copy()
        if op == "roll" and W % K:  # the WRAP instantiation
            send = np.where(tt == tl, w[:, :, sl], send)
        prev = send[:, shfl]
        if op == "shift":
            prev[:, tt == 0] = 0x10000 if i16 else 1
        for k in range(K - 1, 0, -1):
            w[:, :, k] = _add(_moved(w[:, :, k - 1], w[:, :, k], i16),
                              v[:, :, k], i16)
        w[:, :, 0] = _add(_moved(prev, w[:, :, 0], i16), v[:, :, 0], i16)
    out = w.reshape(warps * per_warp, T * K)[:R, :W]
    return _lanes(out, x.dtype)


CASES = (
    # a whole warp a row at W = 32 K
    [("int32", 32 * k, 32, k) for k in (1, 2, 4, 8, 16, 32)]
    + [("int16", 64 * k, 32, k) for k in (1, 2, 4, 8, 16, 32)]
    # the layouts the kernel picks: the probe's rows, the card test's
    # widths, widths that are not K-aligned, rows of up to 32 words
    + [(dt, lanes, None, None) for dt, lanes in (
        ("int32", 512), ("int16", 512), ("int32", 1024), ("int16", 2048),
        ("int32", 500), ("int16", 1000), ("int32", 1000), ("int32", 33),
        ("int32", 100), ("int16", 130), ("int32", 32), ("int16", 32),
        ("int16", 64), ("int32", 20), ("int32", 19), ("int16", 38),
        ("int32", 7), ("int32", 3), ("int16", 2))])


@pytest.mark.parametrize("op", ["roll", "shift"])
@pytest.mark.parametrize(
    "dtype,lanes,T,K", CASES,
    ids=[f"{dt}-{lanes}" + ("" if T is None else f"-T{T}K{K}")
         for dt, lanes, T, K in CASES])
def test_warp_row_model_equals_plain_version(op, dtype, lanes, T, K):
    words = lanes // 2 if dtype == "int16" else lanes
    if T is None:
        T, K = kernels.vpu_layout(op, words)
    rng = np.random.default_rng(lanes + K)
    # odd R: the last warp of a sub-warp layout holds dead rows; inputs
    # near the type's range, so that the sums wrap
    hi = (1 << 30) if dtype == "int32" else 12000
    x = rng.integers(-hi, hi, (5, lanes)).astype(dtype)
    got = move_model(x, STEPS, op, T, K)
    want = kernels.vpu_chain_plain(torch.from_numpy(x), STEPS, op).numpy()
    np.testing.assert_array_equal(got, want)


def test_layout_rule():
    """``vpu_layout``: a warp a row past 32 words, K a power of two that
    covers the row; a sub-warp group of 4-word threads up to 32 words; no
    move, no row groups."""
    assert kernels.vpu_layout("roll", 512) == (32, 16)
    assert kernels.vpu_layout("shift", 256) == (32, 8)
    assert kernels.vpu_layout("roll", 1024) == (32, 32)
    assert kernels.vpu_layout("roll", 500) == (32, 16)
    assert kernels.vpu_layout("roll", 33) == (32, 2)
    assert kernels.vpu_layout("roll", 32) == (8, 4)
    assert kernels.vpu_layout("roll", 16) == (4, 4)
    assert kernels.vpu_layout("roll", 5) == (2, 4)
    assert kernels.vpu_layout("roll", 1) == (1, 4)
    assert kernels.vpu_layout("addmax", 512) == (None, 2)
    assert kernels.vpu_layout("add", 256, i16=True) == (None, 1)
    for words in range(1, 1025):
        T, K = kernels.vpu_layout("roll", words)
        assert T * K >= words and (T == 32 or K == 4)
        assert T * K < 2 * words or words <= 4
    with pytest.raises(ValueError):
        kernels.vpu_layout("roll", 1025)
