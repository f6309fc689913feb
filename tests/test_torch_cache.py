"""The port's KV cache machinery against the reference's
``repro.models.cache``: ring scatters, paged gathers and paged scatters
give bitwise the reference's buffers on the same inputs (they move values
and compute nothing), and a ring holds exactly its last window after any
chunked write pattern (the reference's tests/test_cache.py property).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache as jcache
from repro_torch.configs.base import GLOBAL_WINDOW
from repro_torch.models import cache as cl


def _chunk_positions(rng, B, C, starts, lengths):
    """(B, C) positions: row b holds lengths[b] tokens from starts[b],
    then -1 padding, as a serving tick lays them out."""
    off = np.arange(C)[None]
    return np.where(off < np.asarray(lengths)[:, None],
                    np.asarray(starts)[:, None] + off, -1).astype(np.int32)


@pytest.mark.parametrize("W,C,starts,lengths", [
    (8, 4, (0, 6, 30), (4, 3, 0)),      # partial chunk, wrap, idle row
    (8, 20, (0, 13, 2), (20, 9, 1)),    # chunk longer than the ring
    (16, 1, (3, 40, 0), (1, 1, 0)),     # decode tokens
])
def test_scatter_ring_is_bitwise_the_reference(W, C, starts, lengths):
    rng = np.random.default_rng(W + C)
    B, H, dh = 3, 2, 4
    buf = rng.standard_normal((B, W, H, dh)).astype(np.float32)
    pos = rng.integers(-1, 50, size=(B, W)).astype(np.int32)
    new = rng.standard_normal((B, C, H, dh)).astype(np.float32)
    q_pos = _chunk_positions(rng, B, C, starts, lengths)
    want = jcache.scatter_ring(jnp.asarray(buf), jnp.asarray(new),
                               jnp.asarray(q_pos))
    got = cl.scatter_ring(torch.from_numpy(buf.copy()),
                          torch.from_numpy(new), torch.from_numpy(q_pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_k, want_v, want_p = jcache.update_kv(
        jnp.asarray(buf), jnp.asarray(buf), jnp.asarray(pos),
        jnp.asarray(new), jnp.asarray(new), jnp.asarray(q_pos))
    # the port writes k, v and the entry's pos with one scatter each
    t_q_pos = torch.from_numpy(q_pos)
    got_k, got_v, got_p = (
        cl.scatter_ring(torch.from_numpy(a.copy()), b, t_q_pos)
        for a, b in ((buf, torch.from_numpy(new)),
                     (buf, torch.from_numpy(new)), (pos, t_q_pos)))
    for got, want in ((got_k, want_k), (got_v, want_v), (got_p, want_p)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bs,C,starts,lengths", [
    (4, 6, (0, 5, 9), (6, 2, 0)),
    (8, 1, (3, 17, 30), (1, 1, 1)),     # decode; slot 2's block unleased
    (4, 12, (2, 0, 1), (12, 7, 3)),
])
def test_paged_gather_and_scatter_are_bitwise_the_reference(bs, C, starts,
                                                            lengths):
    rng = np.random.default_rng(bs * C)
    N, B, M, H, dh = 16, 3, 8, 2, 4
    pool = rng.standard_normal((N, bs, H, dh)).astype(np.float32)
    # distinct physical blocks per slot, some logical blocks unleased
    phys = rng.permutation(N).astype(np.int32)
    btab = np.full((B, M), -1, np.int32)
    leased = (5, 4, 3)
    i = 0
    for b in range(B):
        btab[b, :leased[b]] = phys[i:i + leased[b]]
        i += leased[b]
    new = rng.standard_normal((B, C, H, dh)).astype(np.float32)
    q_pos = _chunk_positions(rng, B, C, starts, lengths)

    want = jcache.paged_gather(jnp.asarray(pool), jnp.asarray(btab))
    got = cl.paged_gather(torch.from_numpy(pool), torch.from_numpy(btab))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    want = jcache.paged_scatter(jnp.asarray(pool), jnp.asarray(btab),
                                jnp.asarray(new), jnp.asarray(q_pos))
    got = cl.paged_scatter(torch.from_numpy(pool.copy()),
                           torch.from_numpy(btab), torch.from_numpy(new),
                           torch.from_numpy(q_pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_with_nothing_to_write_leaves_the_buffer():
    buf = torch.arange(24, dtype=torch.float32).view(2, 4, 3)
    q_pos = torch.full((2, 5), -1, dtype=torch.int32)
    out = cl.scatter_ring(buf.clone(), torch.zeros((2, 5, 3)), q_pos)
    assert torch.equal(out, buf)
    btab = torch.tensor([[1, -1], [0, -1]], dtype=torch.int32)
    pool = torch.arange(48, dtype=torch.float32).view(4, 2, 3, 2)
    out = cl.paged_scatter(pool.clone(), btab, torch.ones((2, 1, 3, 2)),
                           torch.tensor([[2], [-1]], dtype=torch.int32))
    assert torch.equal(out, pool)       # slot 0's logical block 1: unleased


@pytest.mark.parametrize("W", [2, 4, 8, 16])
@pytest.mark.parametrize("c_sel", [0, 1, 2, 3])
def test_ring_holds_last_window(W, c_sel):
    """After chunked writes of any width, the ring holds exactly the last W
    positions, each slot's value equal to its position."""
    C = [1, W, 2 * W, max(W // 2, 1)][c_sel]
    B, H, dh = 2, 1, 2
    k = torch.zeros((B, W, H, dh))
    v = torch.zeros((B, W, H, dh))
    pos = torch.full((B, W), -1, dtype=torch.int32)
    total = 0
    for _ in range(5):
        q_pos = torch.arange(total, total + C, dtype=torch.int32).expand(B, C)
        new = q_pos[..., None, None].float().expand(B, C, H, dh)
        k, v, pos = (cl.scatter_ring(k, new, q_pos),
                     cl.scatter_ring(v, new, q_pos),
                     cl.scatter_ring(pos, q_pos, q_pos))
        total += C
    have = sorted(int(x) for x in pos[0] if x >= 0)
    assert have == list(range(max(0, total - W), total))
    for p, val in zip(pos[0].tolist(), k[0, :, 0, 0].tolist()):
        if p >= 0:
            assert val == float(p)


def test_cache_len_for_and_page_spec():
    assert cl.cache_len_for(GLOBAL_WINDOW, 100) == 100
    assert cl.cache_len_for(16, 100) == 16
    assert cl.cache_len_for(0, 100) == 100
    assert cl.logical_blocks(5000, 16) == 313
    assert cl.logical_blocks(5008, 16) == 313
    ent = cl.paged_kv_entry(5, 8, 16, 3, 40, 4, 8)
    assert ent["k"].shape == (5, 8, 16, 4, 8) and ent["pos"].shape == (3, 48)
    assert ent["btab"].shape == (3, 3) and (ent["btab"] == -1).all()
