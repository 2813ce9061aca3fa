"""bloom_build / bloom_probe: the blocked bloom filter of sideways
information passing (SIP).

``bloom_build(keys)`` summarises a join's build-side key column as
``(words, lo, hi)``: ``bloom_n_words(len(keys))`` filter words, each key
setting two bits of one word (``vecops.bloom_hash``), and the inclusive
code range ``[lo, hi]`` (host ints, from one ``torch.aminmax`` on the
device). An empty build gives all-zero words and the empty range (0, -1).
Words are an int32 tensor holding the uint32 bit patterns.

``bloom_probe(words, queries)`` is the (C,) bool membership mask: True
where both of the query's bits are set in its word. No false negatives;
false positives at roughly the filter's load.

Keys of -1 (NULL_ID) hash like any other value. The Pallas build kernel
skips INT32_MIN keys (its padding); codes are >= -1, so it never arises.

CUDA kernels: ``csrc/bloom_filter.cu``. ``bloom_build_plain`` and
``bloom_probe_plain`` are the same functions in PyTorch; the wrappers take
them for CPU tensors only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import vecops
from repro_torch.kernels import build

_I32 = torch.int32
_I64 = torch.int64
build_launches = 0
probe_launches = 0


def _key_range(keys: torch.Tensor) -> Tuple[int, int]:
    if int(keys.shape[0]) == 0:
        return 0, -1
    lo, hi = torch.aminmax(keys)
    lo_h, hi_h = torch.stack([lo, hi]).tolist()  # one device-to-host read
    return int(lo_h), int(hi_h)


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


def bloom_build(keys: torch.Tensor,
                n_words: Optional[int] = None) -> Tuple[torch.Tensor, int, int]:
    """(words, lo, hi) — see module docstring."""
    global build_launches
    _check_1d("bloom_build", "keys", keys)
    n = int(keys.shape[0])
    if n_words is None:
        n_words = vecops.bloom_n_words(n)
    if n_words < 1 or n_words & (n_words - 1):
        raise ValueError(f"bloom_build: n_words={n_words} is not a power of two")
    dev = keys.device
    if dev.type == "cpu":
        return (bloom_build_plain(keys, n_words), *_key_range(keys))
    if dev.type != "cuda":
        raise ValueError(f"bloom_build: unsupported device {dev}")
    words = torch.zeros(n_words, dtype=_I32, device=dev)
    if n:
        lib = build.library()
        build.check(lib.bloom_build_launch(
            keys.data_ptr(), n, n_words, words.data_ptr(), build.stream_handle(keys),
        ), "bloom_build")
        build_launches += 1
    return (words, *_key_range(keys))


def bloom_probe(words: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(C,) bool membership mask over ``queries`` — see module docstring."""
    global probe_launches
    _check_1d("bloom_probe", "words", words)
    _check_1d("bloom_probe", "queries", queries)
    n_words = int(words.shape[0])
    if n_words < 1 or n_words & (n_words - 1):
        raise ValueError(f"bloom_probe: {n_words} words is not a power of two")
    dev = queries.device
    if words.device != dev:
        raise ValueError(f"bloom_probe: words are on {words.device}, not {dev}")
    if dev.type == "cpu":
        return bloom_probe_plain(words, queries)
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
    return out


def _check_1d(who: str, name: str, x: torch.Tensor) -> None:
    if x.dtype != _I32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be a contiguous 1-D int32 tensor")
