"""``bloom_build`` on the CPU against the JAX package: the plain version
against the numpy oracle (``vecops.bloom_build``) and the Pallas kernel in
interpret mode, words bit for bit and ``(lo, hi)`` exactly, on seeded
numpy keys in random order and in the engine's grouped order (sorted by
radix partition, then key, as the hash join lays its build out), all
equal, half NULL (-1), and empty; at 4,096 keys (``W = 2^11 < 2^14``),
20,000 (``W = 2^14``) and 40,000 (``W = 2^15``, past the 2^14 words a key
can reach). Then the wrapper's host-side parts of the one-launch build:
``launch_shape`` and the decoding of the kernel's range words.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import vecops as RV  # noqa: E402
from repro.kernels.bloom_filter import bloom_build_pallas  # noqa: E402

from repro_torch.core import vecops as TV  # noqa: E402
from repro_torch.kernels import bloom_filter as BF  # noqa: E402

ORDERS = ("random", "grouped", "all equal", "half NULL")
SIZES = (4096, 20_000, 40_000)
ENGINE_PARTS = 16  # radix partitions of the grouped order


def _keys(order: str, n: int) -> np.ndarray:
    rng = np.random.RandomState(n + len(order))
    if order == "all equal":
        return np.full(n, 12345, np.int32)
    keys = rng.randint(0, 300_000, n).astype(np.int32)
    if order == "half NULL":
        keys[rng.permutation(n)[: n // 2]] = -1
    if order == "grouped":
        # the hash join's build layout: by partition id, then by key, so
        # equal keys sit next to each other
        keys = rng.randint(0, n // 3, n).astype(np.int32)
        pid = ((keys.astype(np.uint32) * np.uint32(0x9E3779B1)) >> np.uint32(16)) \
            & np.uint32(ENGINE_PARTS - 1)
        keys = keys[np.lexsort((keys, pid))]
    return keys


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("order", ORDERS)
def test_bloom_build_matches_numpy_and_pallas(order, n):
    keys = _keys(order, n)
    words, lo, hi = BF.bloom_build(torch.from_numpy(keys))
    n_words = TV.bloom_n_words(n)
    assert n_words == RV.bloom_n_words(n) and words.shape == (n_words,)
    assert words.dtype == torch.int32
    want, want_lo, want_hi = RV.bloom_build(keys, n_words)
    np.testing.assert_array_equal(_u32(words), want)
    assert (lo, hi) == (want_lo, want_hi) == (int(keys.min()), int(keys.max()))
    np.testing.assert_array_equal(_u32(words), np.asarray(bloom_build_pallas(keys, n_words)))
    # only the first 2^14 words are reachable: the rest stay zero
    assert not _u32(words)[BF.REACH:].any()


def test_bloom_build_of_nothing():
    keys = np.zeros(0, np.int32)
    words, lo, hi = BF.bloom_build(torch.from_numpy(keys))
    want, want_lo, want_hi = RV.bloom_build(keys, TV.bloom_n_words(0))
    np.testing.assert_array_equal(_u32(words), want)
    np.testing.assert_array_equal(_u32(words), np.asarray(bloom_build_pallas(keys, len(want))))
    assert (lo, hi) == (want_lo, want_hi) == (0, -1)
    assert not words.any()


@pytest.mark.parametrize("n", [0, 1, 4096, 8192, 8193, 65_536, 131_072, 1 << 18, 540_672,
                               1_369_041, 1 << 24])
def test_launch_shape_covers_the_keys(n):
    """A block for every KEYS_PER_BLOCK keys until the grid holds a block
    an SM; one block alone (it stores its copy) up to KEYS_PER_BLOCK."""
    blocks = BF.launch_shape(n)
    assert 1 <= blocks <= BF.BUILD_BLOCKS
    assert blocks == min(BF.BUILD_BLOCKS, max(1, -(-n // BF.KEYS_PER_BLOCK)))
    assert (blocks == 1) == (n <= BF.KEYS_PER_BLOCK)


@pytest.mark.parametrize("keys", [[-1], [0], [5, -7, 3], [-(2 ** 31), 2 ** 31 - 1],
                                  [2 ** 31 - 1], [-(2 ** 31)]])
def test_range_words_decode(keys):
    """The kernel's range words, modelled in numpy: the uint32 maxima of
    ~(key ^ 2^31) and of key ^ 2^31 over the keys, read back as int32."""
    biased = np.asarray(keys, np.int64).astype(np.int32).view(np.uint32) ^ np.uint32(1 << 31)
    words = np.asarray([(~biased).max(), biased.max()], np.uint32).view(np.int32)
    assert BF._decode_range(*map(int, words)) == (min(keys), max(keys))


def test_bloom_build_refuses_bad_word_counts():
    keys = torch.zeros(4, dtype=torch.int32)
    for n_words in (0, 3, 1 << 31):
        with pytest.raises(ValueError, match="power of two"):
            BF.bloom_build(keys, n_words)
