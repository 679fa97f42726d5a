"""The port's words layout (hnsw_tpu_torch.ops.packed: word_width,
pack_words, unpack_words, unpack_nibbles, pack_neighbors(layout="words"),
bits_for, make_packed_expand) against the reference's, on the CPU. Inputs
are made with numpy from a seed and go to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_tpu.ops import packed as ref
from hnsw_tpu_torch.ops import packed
from hnsw_tpu_torch.ops.storage import Storage

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

CASES = [(128, 8), (128, 4), (100, 8), (24, 8), (17, 4)]


def test_word_width_table():
    for d in (1, 4, 17, 24, 64, 96, 100, 128, 500, 960, 1024, 1100):
        for bits in (8, 4):
            assert packed.word_width(d, bits) == ref.word_width(d, bits)
    assert packed.word_width(128, 8) == 32 and packed.word_width(960, 8) == 0


@pytest.mark.parametrize("d,bits", CASES)
def test_pack_words_matches_reference_and_round_trips(d, bits):
    """Word for word the reference's int32 words, the wrap case included
    (every value at its maximum sets bit 31), and back."""
    rng = np.random.default_rng(d * 10 + bits)
    vals = rng.integers(0, 1 << bits, size=(37, d), dtype=np.uint8)
    vals[0, :] = (1 << bits) - 1
    words = packed.pack_words(torch.from_numpy(vals), bits)
    assert words.dtype == torch.int32
    assert tuple(words.shape) == (37, packed.word_width(d, bits))
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(ref.pack_words(jnp.asarray(vals), bits)))
    np.testing.assert_array_equal(
        packed.unpack_words(words, bits, d).numpy(), vals)


def test_pack_words_holds_the_bytes_layout_bits():
    """At d = 128 8-bit there is no pad: the words are the uint8 codes seen
    as little-endian int32."""
    vals = np.random.default_rng(7).integers(0, 256, size=(11, 128),
                                              dtype=np.uint8)
    words = packed.pack_words(torch.from_numpy(vals), 8)
    assert torch.equal(words.view(torch.uint8), torch.from_numpy(vals))


def test_unpack_nibbles_matches_reference():
    rows = np.random.default_rng(3).integers(0, 256, size=(5, 9, 13),
                                             dtype=np.uint8)
    for d in (25, 26):
        np.testing.assert_array_equal(
            packed.unpack_nibbles(torch.from_numpy(rows), d).numpy(),
            np.asarray(ref.unpack_nibbles(jnp.asarray(rows), d)))


def _random_graph(d, seed, cap=300, m0=12):
    """pack_neighbors needs no real graph: random adjacency (-1 padded),
    levels (-1 = not inserted) and vectors."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, cap, size=(cap, m0), dtype=np.int32)
    nb[rng.random((cap, m0)) < 0.2] = -1
    levels = rng.integers(-1, 3, size=cap).astype(np.int32)
    vecs = (rng.normal(size=(cap, d)) * rng.uniform(0.5, 3, size=d)
            ).astype(np.float32)
    return nb, vecs, levels


@pytest.mark.parametrize("d,bits", CASES)
def test_pack_neighbors_words_matches_reference(d, bits):
    """``nbr_codes`` word for word, the norms to f32 rounding, the affine
    exactly, and the layout / bits read back from the table."""
    nb, vecs, levels = _random_graph(d, d + bits)
    n = 250
    want = ref.pack_neighbors(jnp.asarray(nb), jnp.asarray(vecs),
                              jnp.asarray(levels), bits=bits, n_rows=n,
                              layout="words")
    got = packed.pack_neighbors(torch.from_numpy(nb),
                                Storage(torch.from_numpy(vecs)),
                                torch.from_numpy(levels), bits=bits,
                                n_rows=n, layout="words")
    assert got.layout == want.layout == "words"
    np.testing.assert_array_equal(got.nbr_codes.numpy(),
                                  np.asarray(want.nbr_codes)[:n])
    np.testing.assert_allclose(got.nbr_sq.numpy(),
                               np.asarray(want.nbr_sq)[:n], rtol=1e-6)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.bits_for(d, nb.shape[1]) == bits


def test_bits_for_words_tables():
    """8/4-bit read back from the row width; the reference's ambiguity and
    mismatch errors."""
    m0 = 4
    for d, bits in CASES:
        p = packed.PackedNeighbors(
            torch.zeros((2, m0 * packed.word_width(d, bits)),
                        dtype=torch.int32),
            torch.zeros((2, m0)), torch.ones(d), torch.zeros(d))
        assert p.layout == "words" and p.bits_for(d, m0) == bits
    tiny = packed.PackedNeighbors(torch.zeros((2, m0), dtype=torch.int32),
                                  torch.zeros((2, m0)), torch.ones(3),
                                  torch.zeros(3))
    with pytest.raises(ValueError, match="ambiguous"):
        tiny.bits_for(3, m0)
    with pytest.raises(ValueError, match="matches neither"):
        tiny.bits_for(40, m0)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_make_packed_expand_words_equals_bytes(metric):
    """The same code values through K2 (bytes) and K4 (words), two expanded
    nodes per query (T = 2): the same neighbors, the same distances to f32
    rounding (sums in another order)."""
    nb, vecs, levels = _random_graph(100, 5)
    tnb, tv, tl = map(torch.from_numpy, (nb, vecs, levels))
    q = torch.from_numpy(np.random.default_rng(6).normal(size=(20, 100))
                         .astype(np.float32))
    cur = torch.from_numpy(np.random.default_rng(8).integers(
        0, 250, size=(20, 2), dtype=np.int32))
    ok = torch.ones((20, 2), dtype=torch.bool)
    out = []
    for layout in ("bytes", "words"):
        p = packed.pack_neighbors(tnb, Storage(tv), tl, bits=8, n_rows=250,
                                  layout=layout)
        expand, shift = packed.make_packed_expand(p, tnb, q, metric)
        out.append(expand(cur, ok) + (shift,))
    (nb_b, d_b, s_b), (nb_w, d_w, s_w) = out
    assert torch.equal(nb_b, nb_w) and tuple(nb_w.shape) == (20, 2, 12)
    assert tuple(d_w.shape) == (20, 24) and torch.equal(s_b, s_w)
    np.testing.assert_allclose(d_w.numpy(), d_b.numpy(), rtol=1e-5,
                               atol=1e-3)
