"""The port's paged KV allocator and device helpers: the cases of
tests/test_kv_pages.py run on repro_torch.core.kv_pages, and the gather /
kpos / scatter / strip helpers held against the JAX reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_pages as jkv
from repro_torch.core.kv_pages import (KVPagesExhausted, PageAllocator,
                                       gather_pages, pages_for, pages_kpos,
                                       pages_to_strips, scatter_rows)


def test_pages_for():
    for n, ps in [(0, 8), (1, 8), (8, 8), (9, 8), (64, 16), (-3, 4)]:
        assert pages_for(n, ps) == jkv.pages_for(n, ps)
    assert pages_for(9, 8) == 2 and pages_for(64, 16) == 4


def test_alloc_free_roundtrip():
    a = PageAllocator(4, 8)
    got = a.alloc(3)
    assert sorted(got) == [0, 1, 2]          # lowest-id-first (compaction)
    assert a.num_free == 1 and a.num_in_use == 3
    a.free(got[:2])
    assert a.num_free == 3
    assert sorted(a.alloc(2)) == sorted(got[:2])
    a.free([0, 1, 2])
    a.check_balanced()


def test_exhaustion_raises_and_allocates_nothing():
    a = PageAllocator(2, 8)
    a.alloc(1)
    with pytest.raises(KVPagesExhausted):
        a.alloc(2)
    assert a.num_free == 1


def test_double_free_raises():
    a = PageAllocator(2, 8)
    pages = a.alloc(2)
    a.free(pages[:1])
    with pytest.raises(ValueError):
        a.free(pages[:1])
    with pytest.raises(ValueError):
        a.free([99])
    assert a.num_free == 1


def test_peak_tracks_high_water():
    a = PageAllocator(8, 4)
    a.free(a.alloc(3))
    a.alloc(2)
    assert a.peak_pages == 3
    a.alloc(4)
    assert a.peak_pages == 6


def test_check_balanced_detects_leak():
    a = PageAllocator(2, 4)
    a.alloc(1)
    with pytest.raises(AssertionError):
        a.check_balanced()
    a.free(list(a._in_use))
    a.check_balanced()


def test_allocator_sequence_matches_reference(rng):
    """A random alloc/free sequence gives the same ids, counts and peak in
    both allocators."""
    mine, ref = PageAllocator(16, 4), jkv.PageAllocator(16, 4)
    held = []
    for _ in range(60):
        if held and rng.random() < 0.45:
            take = held.pop(int(rng.integers(0, len(held))))
            mine.free(take)
            ref.free(take)
        else:
            n = int(rng.integers(0, 4))
            if n > mine.num_free:
                with pytest.raises(KVPagesExhausted):
                    mine.alloc(n)
                continue
            got = mine.alloc(n)
            assert got == ref.alloc(n)
            held.append(got)
        assert (mine.num_free, mine.num_in_use, mine.peak_pages) == \
            (ref.num_free, ref.num_in_use, ref.peak_pages)


def test_gather_pages_and_kpos_match_reference(rng):
    P, ps, d = 5, 4, 3
    pool = rng.normal(size=(P + 1, ps, d)).astype(np.float32)
    pages = np.asarray([[2, 0, -1], [-1, -1, -1]], np.int32)
    g = gather_pages(torch.from_numpy(pool), torch.from_numpy(pages))
    assert g.shape == (2, 3 * ps, d)
    np.testing.assert_array_equal(g.numpy(), np.asarray(
        jkv.gather_pages(jnp.asarray(pool), jnp.asarray(pages))))
    kpos = pages_kpos(torch.from_numpy(pages), ps)
    assert kpos.dtype == torch.int32
    assert kpos[0].tolist() == list(range(2 * ps)) + [-1] * ps
    np.testing.assert_array_equal(kpos.numpy(), np.asarray(
        jkv.pages_kpos(jnp.asarray(pages), ps)))


def test_pages_to_strips_matches_reference(rng):
    P, ps, hkv, dh = 4, 2, 2, 3
    kp = rng.normal(size=(P + 1, ps, hkv, dh)).astype(np.float32)
    vp = rng.normal(size=(P + 1, ps, hkv, dh)).astype(np.float32)
    pages = np.asarray([[1, 3], [-1, 2]], np.int32)
    got = pages_to_strips((torch.from_numpy(kp), torch.from_numpy(vp)),
                          torch.from_numpy(pages), ps)
    want = jkv.pages_to_strips((jnp.asarray(kp), jnp.asarray(vp)),
                               jnp.asarray(pages), ps)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_scatter_rows_matches_reference(rng):
    """Real rows land where the reference puts them; pad rows and rows of
    unallocated pages go to the scratch page only (never read back)."""
    P, ps, hkv, dh = 6, 4, 2, 3
    pool = rng.normal(size=(P + 1, ps, hkv, dh)).astype(np.float32)
    pages = np.asarray([[3, 1, -1], [0, -1, -1]], np.int32)
    positions = np.asarray([[2, 3, 4, 5, 9], [0, 1, -1, -1, -1]], np.int32)
    rows = rng.normal(size=(2, 5, hkv, dh)).astype(np.float32)
    got = scatter_rows(torch.from_numpy(pool.copy()), torch.from_numpy(pages),
                       torch.from_numpy(positions), torch.from_numpy(rows))
    want = np.asarray(jkv.scatter_rows(jnp.asarray(pool), jnp.asarray(pages),
                                       jnp.asarray(positions),
                                       jnp.asarray(rows)))
    np.testing.assert_array_equal(got.numpy()[:P], want[:P])
    np.testing.assert_array_equal(got.numpy()[3, 2], rows[0, 0])
    np.testing.assert_array_equal(got.numpy()[1, 1], rows[0, 3])
