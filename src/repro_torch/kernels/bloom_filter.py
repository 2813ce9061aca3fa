"""bloom_build / bloom_probe: the blocked bloom filter of sideways
information passing (SIP).

``bloom_build(keys)`` summarises a join's build-side key column as
``(words, lo, hi)``: ``bloom_n_words(len(keys))`` filter words, each key
setting two bits of one word (``vecops.bloom_hash``), and the inclusive
code range ``[lo, hi]`` (host ints). An empty build gives all-zero words
and the empty range (0, -1). Words are an int32 tensor holding the uint32
bit patterns.

``bloom_probe(words, queries)`` is the (C,) bool membership mask: True
where both of the query's bits are set in its word. No false negatives;
false positives at roughly the filter's load.

``sip_mask(mask, n_rows, filters)`` is a scan batch's whole SIP mask:
each filter is ``(codes, words or None, lo, hi)``, and for ``i < n_rows``
``out[i] = mask[i] and`` every filter's ``lo <= codes[i] <= hi`` and, where
it has words, membership of ``codes[i]``; ``out[i]`` is False from
``n_rows`` to the mask's end. ``out`` is ``mask`` unless given (in place);
a ``mask`` of None reads as all True. ``counts``, where given, holds for
each filter None or its counter pair (a zeroed contiguous (2,) int64
tensor, the SIP filter's row for this batch): the same launch adds the
rows of the first ``n_rows`` that the filter alone rejects, whatever the
mask holds, and sets the second word to 1 where the filter has words and
a code fell inside its range (a bloom probe), as the reference counts a
filter.

Keys of -1 (NULL_ID) hash like any other value. The Pallas build kernel
skips INT32_MIN keys (its padding); codes are >= -1, so it never arises.

CUDA kernels: ``csrc/bloom_filter.cu``. The build is one launch that
writes every word and the key range: each block ORs its keys into a copy of
the ``REACH`` words a key can reach in shared memory, and the blocks OR
their copies into the words with global atomics (``launch_shape`` gives
the blocks); the range, a start ticket and a flag come in ``STATE_WORDS``
words cut from a zeroed slab (``build.zeroed``), and the range comes back
with one device-to-host read. ``bloom_probe`` and ``sip_mask``
are two entry points of one kernel: ``sip_mask`` passes up to ``SIP_TERMS``
filters by value in one launch (a longer list takes further launches over
the same mask), and ``bloom_probe`` is its one-filter case over the whole
int32 range, writing a fresh mask. ``bloom_build_plain``,
``bloom_probe_plain`` and ``sip_mask_plain`` are the same functions in
PyTorch; the wrappers take them for CPU tensors only. ``probe_launches``
counts the probe kernel's launches in both modes, ``wordless_launches``
those whose filters carried no words (range only).
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import vecops
from repro_torch.kernels import build

_I32 = torch.int32
_I64 = torch.int64
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
# filters one launch's descriptor holds (csrc/bloom_filter.cu), checked
# when the library loads
SIP_TERMS = 4
# the build's compiled shape (csrc/bloom_filter.cu), checked when the
# library loads: threads a block, the words a key can reach ((h1 >> 18)
# has 14 bits), and the zeroed state words (the range, a start ticket and
# the flag that the reachable words are zero, on three L2 lines)
BUILD_THREADS = 1024
REACH = 1 << 14
STATE_WORDS = 96
# the build's launch shape (kernel_sweep.py's choice): a block for every
# KEYS_PER_BLOCK keys, at most BUILD_BLOCKS (one an SM of the H100)
KEYS_PER_BLOCK = 8192
BUILD_BLOCKS = 132
# 64-bit words: four a filter, the count, then a counter pair's pointer a filter
_DESC_WORDS = 5 * SIP_TERMS + 1
build_launches = 0
probe_launches = 0
wordless_launches = 0

# a SIP filter as sip_mask takes it: (codes, words or None, lo, hi)
SipTerm = Tuple[torch.Tensor, Optional[torch.Tensor], int, int]


def _key_range(keys: torch.Tensor) -> Tuple[int, int]:
    if int(keys.shape[0]) == 0:
        return 0, -1
    lo, hi = torch.aminmax(keys)
    return int(lo), int(hi)


def _decode_range(lo_m: int, hi_m: int) -> Tuple[int, int]:
    """The kernel's range words: the maxima of ``~(key ^ 2^31)`` and of
    ``key ^ 2^31`` as uint32 (int32 here), so zero is their identity."""
    lo_m, hi_m = lo_m & 0xFFFFFFFF, hi_m & 0xFFFFFFFF
    return (1 << 31) - 1 - lo_m, hi_m - (1 << 31)


def launch_shape(n: int) -> int:
    """The blocks of a build of ``n`` keys: one for every ``KEYS_PER_BLOCK``
    keys, at most ``BUILD_BLOCKS``. One block alone stores its copy."""
    return min(BUILD_BLOCKS, max(1, -(-n // KEYS_PER_BLOCK)))


def bloom_build_plain(keys: torch.Tensor, n_words: int) -> torch.Tensor:
    """(n_words,) int32 words. torch has no scatter-OR, so the OR goes bit
    plane by bit plane: a scatter-max of each key's bit into its word."""
    words = torch.zeros(n_words, dtype=_I64, device=keys.device)
    if int(keys.shape[0]):
        word, bits = vecops.bloom_hash(keys, n_words)
        for b in range(32):
            plane = torch.zeros(n_words, dtype=_I64, device=keys.device)
            plane.scatter_reduce_(0, word, (bits >> b) & 1, "amax")
            words |= plane << b
    return vecops._as_i32(words)


def bloom_probe_plain(words: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    word, bits = vecops.bloom_hash(queries, int(words.shape[0]))
    return (vecops._u32(words)[word] & bits) == bits


def _clamp_range(lo: int, hi: int) -> Tuple[int, int]:
    """The inclusive range [lo, hi] cut to int32 (codes are int32): an empty
    range stays empty."""
    lo, hi = max(int(lo), _INT32_MIN), min(int(hi), _INT32_MAX)
    return (lo, hi) if lo <= hi else (0, -1)


def sip_mask_plain(mask: Optional[torch.Tensor], n_rows: int, filters: Sequence[SipTerm],
                   out: Optional[torch.Tensor] = None,
                   counts: Optional[Sequence[Optional[torch.Tensor]]] = None) -> torch.Tensor:
    out = _sip_out(mask, n_rows, filters, out)
    keep = out[:n_rows]
    if mask is None:
        keep.fill_(True)
    elif out is not mask:
        keep.copy_(mask[:n_rows])
    for k, (codes, words, lo, hi) in enumerate(filters):
        c = codes[:n_rows]
        lo, hi = _clamp_range(lo, hi)
        in_range = (c >= lo) & (c <= hi)
        m = in_range if words is None else in_range & bloom_probe_plain(words, c)
        keep &= m
        pair = None if counts is None else counts[k]
        if pair is not None:
            pair[0] += (~m).sum()
            if words is not None:
                pair[1] = torch.maximum(pair[1], in_range.any().to(_I64))
    out[n_rows:] = False
    return out


def bloom_build(keys: torch.Tensor,
                n_words: Optional[int] = None) -> Tuple[torch.Tensor, int, int]:
    """(words, lo, hi) — see module docstring."""
    global build_launches
    t0 = time.perf_counter()
    _check_1d("bloom_build", "keys", keys)
    n = int(keys.shape[0])
    if n_words is None:
        n_words = vecops.bloom_n_words(n)
    if n_words < 1 or n_words & (n_words - 1) or n_words > 1 << 30:
        raise ValueError(f"bloom_build: n_words={n_words} is not a power of two up to 2^30")
    dev = keys.device
    if dev.type == "cpu":
        out = (bloom_build_plain(keys, n_words), *_key_range(keys))
        build.ledger("bloom_build", "plain", t0)
        return out
    if dev.type != "cuda":
        raise ValueError(f"bloom_build: unsupported device {dev}")
    stream = build.stream_handle(keys)
    words = torch.empty(n_words, dtype=_I32, device=dev)
    state = build.zeroed(dev, STATE_WORDS, stream)
    lib = build.library()
    _check_build_limits(lib)
    build.check(lib.bloom_build_launch(
        keys.data_ptr(), n, n_words, words.data_ptr(), state.data_ptr(), launch_shape(n),
        stream), "bloom_build")
    build_launches += 1
    build.ledger("bloom_build", "cuda", t0)
    if n == 0:
        return words, 0, -1
    return (words, *_decode_range(*state[:2].tolist()))  # one device-to-host read


def bloom_probe(words: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(C,) bool membership mask over ``queries`` — see module docstring."""
    global probe_launches
    t0 = time.perf_counter()
    _check_1d("bloom_probe", "words", words)
    _check_1d("bloom_probe", "queries", queries)
    n_words = int(words.shape[0])
    if n_words < 1 or n_words & (n_words - 1):
        raise ValueError(f"bloom_probe: {n_words} words is not a power of two")
    dev = queries.device
    if words.device != dev:
        raise ValueError(f"bloom_probe: words are on {words.device}, not {dev}")
    if dev.type == "cpu":
        out = bloom_probe_plain(words, queries)
        build.ledger("bloom_probe", "plain", t0)
        return out
    if dev.type != "cuda":
        raise ValueError(f"bloom_probe: unsupported device {dev}")
    c = int(queries.shape[0])
    out = torch.empty(c, dtype=torch.bool, device=dev)
    if c:
        lib = build.library()
        build.check(lib.bloom_probe_launch(
            words.data_ptr(), n_words, queries.data_ptr(), c, out.data_ptr(),
            build.stream_handle(queries),
        ), "bloom_probe")
        probe_launches += 1
        build.ledger("bloom_probe", "cuda", t0)
    return out


def sip_mask(mask: Optional[torch.Tensor], n_rows: int, filters: Sequence[SipTerm],
             out: Optional[torch.Tensor] = None,
             counts: Optional[Sequence[Optional[torch.Tensor]]] = None) -> torch.Tensor:
    """The SIP mask of a batch's first ``n_rows`` rows (see module
    docstring); returns ``out``."""
    global probe_launches, wordless_launches
    t0 = time.perf_counter()
    out = _sip_out(mask, n_rows, filters, out)
    dev = out.device
    for x in ((out,) if mask is None else (mask, out)):
        if x.dtype != torch.bool or x.dim() != 1 or not x.is_contiguous() or x.device != dev:
            raise ValueError("sip_mask: masks must be contiguous 1-D bool tensors on one device")
    if mask is not None and mask.shape != out.shape:
        raise ValueError("sip_mask: mask and out differ in length")
    if not 0 <= n_rows <= int(out.shape[0]):
        raise ValueError(f"sip_mask: n_rows={n_rows} outside the mask's {int(out.shape[0])}")
    for codes, words, _, _ in filters:
        _check_1d("sip_mask", "codes", codes)
        if int(codes.shape[0]) < n_rows or codes.device != dev:
            raise ValueError(f"sip_mask: codes must hold {n_rows} rows on {dev}")
        if words is not None:
            _check_1d("sip_mask", "words", words)
            w = int(words.shape[0])
            if w < 1 or w & (w - 1) or words.device != dev:
                raise ValueError(f"sip_mask: words must be a power of two on {dev}")
    if counts is not None:
        if len(counts) != len(filters):
            raise ValueError("sip_mask: one counter pair (or None) a filter")
        for x in counts:
            if x is not None and (x.dtype != _I64 or x.shape != (2,) or not x.is_contiguous()
                                  or x.device != dev):
                raise ValueError(f"sip_mask: a counter pair is a contiguous (2,) int64 "
                                 f"tensor on {dev}")
    if dev.type == "cpu":
        out = sip_mask_plain(mask, n_rows, filters, out, counts)
        build.ledger("bloom_probe", "plain", t0)
        return out
    if dev.type != "cuda":
        raise ValueError(f"sip_mask: unsupported device {dev}")
    lib = build.library()
    _check_limits(lib)
    stream = build.stream_handle(out)
    src = mask
    for k in range(0, max(len(filters), 1), SIP_TERMS):
        chunk = filters[k: k + SIP_TERMS]
        desc = _descriptor(chunk, None if counts is None else counts[k: k + SIP_TERMS])
        build.check(lib.sip_mask_launch(
            ctypes.addressof(desc), None if src is None else src.data_ptr(),
            out.data_ptr(), n_rows, int(out.shape[0]), stream), "sip_mask")
        probe_launches += 1
        t0 = build.ledger("bloom_probe", "cuda", t0)
        wordless_launches += all(t[1] is None for t in chunk)
        src = out
    return out


def _sip_out(mask: Optional[torch.Tensor], n_rows: int, filters: Sequence[SipTerm],
             out: Optional[torch.Tensor]) -> torch.Tensor:
    """``out``, else ``mask`` (in place), else a fresh mask of ``n_rows``
    on the first filter's device."""
    if out is not None:
        return out
    if mask is not None:
        return mask
    if not filters:
        raise ValueError("sip_mask: give a mask, an out or a filter")
    return torch.empty(n_rows, dtype=torch.bool, device=filters[0][0].device)


def _descriptor(chunk: Sequence[SipTerm],
                counts: Optional[Sequence[Optional[torch.Tensor]]] = None) -> ctypes.Array:
    """The kernel's by-value descriptor (kept alive through the call): per
    filter the codes and words pointers, the words' index mask and (lo,
    hi) packed in one word; the filter count; per filter its counter
    pair's pointer or 0."""
    d = (ctypes.c_uint64 * _DESC_WORDS)()
    for k, (codes, words, lo, hi) in enumerate(chunk):
        lo, hi = _clamp_range(lo, hi)
        d[4 * k] = codes.data_ptr()
        if words is not None:
            d[4 * k + 1] = words.data_ptr()
            d[4 * k + 2] = int(words.shape[0]) - 1
        d[4 * k + 3] = (lo & 0xFFFFFFFF) | (hi & 0xFFFFFFFF) << 32
    d[4 * SIP_TERMS] = len(chunk)
    for k, x in enumerate(counts or ()):
        if x is not None:
            d[4 * SIP_TERMS + 1 + k] = x.data_ptr()
    return d


@functools.lru_cache(maxsize=1)
def _check_build_limits(lib) -> None:
    got = [ctypes.c_int() for _ in range(3)]
    lib.bloom_build_limits(*[ctypes.byref(x) for x in got])
    want = (BUILD_THREADS, REACH, STATE_WORDS)
    if tuple(x.value for x in got) != want:
        raise RuntimeError(f"bloom_build: kernel shape {[x.value for x in got]} != {want}")


@functools.lru_cache(maxsize=1)
def _check_limits(lib) -> None:
    got = [ctypes.c_int() for _ in range(2)]
    lib.sip_mask_limits(*[ctypes.byref(x) for x in got])
    want = (SIP_TERMS, 8 * _DESC_WORDS)
    if tuple(x.value for x in got) != want:
        raise RuntimeError(f"sip_mask: kernel descriptor {[x.value for x in got]} != {want}")


def _check_1d(who: str, name: str, x: torch.Tensor) -> None:
    if x.dtype != _I32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be a contiguous 1-D int32 tensor")
