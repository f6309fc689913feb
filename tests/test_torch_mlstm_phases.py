"""The two phases of the CUDA mLSTM kernel's chunk-parallel layout, in plain
PyTorch on the CPU, against the reference.

Phase 1 computes the state entering every chunk (``ref.mlstm_chunk_states``);
phase 2 computes each chunk's outputs from its entering state alone
(``ref.mlstm_chunk_step``).  Composed, they must give the sequential chunk
loop ``ref.mlstm_chunk_ref``: to 1e-6 of the output's scale, since both
sides run the same f32 operations.  Against the reference's chunk loop
(``repro.models.ssm._mlstm_chunk``) and its Pallas kernel in interpret mode
(zero state) they must agree to 1e-5 of scale: f32 sums of at most L*dh
products taken in another order.

    PYTHONPATH=src python -m pytest tests/test_torch_mlstm_phases.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk import mlstm_chunk as pallas_mlstm_chunk
from repro.models.ssm import _mlstm_chunk
from repro_torch.kernels import ref

COMPOSE_TOL = 1e-6
REF_TOL = 1e-5


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


def _inputs(B, H, S, dh, seed, state):
    """q/k/v/li/lf as the reference's kernel test draws them, and a state:
    zero (m = -inf), random, or random with m = -inf."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, dh)).astype(np.float32)
               for _ in range(3))
    li = (0.5 * rng.standard_normal((B, H, S))).astype(np.float32)
    lf = -np.log1p(np.exp(-(rng.standard_normal((B, H, S)) + 2.0)))
    lf = lf.astype(np.float32)
    if state == "zero":
        st = (np.zeros((B, H, dh, dh), np.float32),
              np.zeros((B, H, dh), np.float32),
              np.full((B, H), -np.inf, np.float32))
    else:
        st = (rng.standard_normal((B, H, dh, dh)).astype(np.float32),
              rng.standard_normal((B, H, dh)).astype(np.float32),
              rng.standard_normal((B, H)).astype(np.float32))
        if state == "m_inf":
            st[2][:] = -np.inf
    return (q, k, v, li, lf), st


def _torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _phases(xs, st, chunk):
    """Phase 1, then every chunk's outputs from its entering state."""
    q, k, v, li, lf = xs
    S = q.shape[2]
    L = ref.chunk_len(S, chunk)
    (Ce, ne, me), final = ref.mlstm_chunk_states(k, v, li, lf, st,
                                                 chunk=chunk)
    hs = []
    for c, c0 in enumerate(range(0, S, L)):
        sl = slice(c0, c0 + L)
        h, _ = ref.mlstm_chunk_step(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                    li[:, :, sl], lf[:, :, sl],
                                    (Ce[:, :, c], ne[:, :, c], me[:, :, c]))
        hs.append(h)
    return torch.cat(hs, dim=2), (Ce, ne, me), final


@pytest.mark.parametrize("B,H,S,dh,chunk,state", [
    (2, 3, 64, 16, 16, "random"),    # four chunks from a carried state
    (2, 3, 64, 16, 16, "m_inf"),     # a fresh slot: m = -inf, C/n nonzero
    (1, 2, 40, 16, 16, "random"),    # S % chunk != 0: one chunk of L = S
    (1, 2, 12, 8, 1, "random"),      # chunks of one step
    (2, 2, 96, 32, 32, "zero"),      # zero state, three chunks
])
def test_phases_compose_to_the_chunk_loop(B, H, S, dh, chunk, state):
    xs, st = _inputs(B, H, S, dh, seed=3 * S + dh + chunk, state=state)
    xs, st = _torch(xs), _torch(st)
    h, entering, final = _phases(xs, st, chunk)
    h_r, final_r = ref.mlstm_chunk_ref(*xs, st, chunk=chunk)
    assert _err(h, h_r) < COMPOSE_TOL
    for got, want in zip(final, final_r):
        assert _err(got, want) < COMPOSE_TOL
    for got, want in zip(entering, st):          # chunk 0 enters as given
        assert torch.equal(got[:, :, 0], want)


def _jax_states(xs, st, chunk):
    """The reference's chunk loop over ``_mlstm_chunk``: its outputs and the
    state entering each chunk."""
    q, k, v, li, lf = (jnp.asarray(a) for a in xs)
    state = tuple(jnp.asarray(a) for a in st)
    S = q.shape[2]
    L = ref.chunk_len(S, chunk)
    hs, entering = [], []
    for c0 in range(0, S, L):
        entering.append([np.asarray(a) for a in state])
        sl = slice(c0, c0 + L)
        h, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                li[:, :, sl], lf[:, :, sl], state)
        hs.append(np.asarray(h))
    return np.concatenate(hs, axis=2), entering, [np.asarray(a)
                                                  for a in state]


@pytest.mark.parametrize("B,H,S,dh,chunk,state", [
    (2, 3, 64, 16, 16, "random"),
    (2, 3, 64, 16, 16, "m_inf"),
    (1, 2, 40, 16, 16, "random"),
    (1, 2, 12, 8, 1, "random"),
    (2, 2, 96, 32, 32, "zero"),
])
def test_phases_match_the_reference_chunk_loop(B, H, S, dh, chunk, state):
    xs_np, st_np = _inputs(B, H, S, dh, seed=5 * S + dh + chunk,
                           state=state)
    h, (Ce, ne, me), final = _phases(_torch(xs_np), _torch(st_np), chunk)
    h_j, entering_j, final_j = _jax_states(xs_np, st_np, chunk)
    assert _err(h, h_j) < REF_TOL
    for c, (C_j, n_j, m_j) in enumerate(entering_j):
        assert _err(Ce[:, :, c], C_j) < REF_TOL
        assert _err(ne[:, :, c], n_j) < REF_TOL
        m_c = me[:, :, c].numpy()
        assert np.array_equal(np.isinf(m_c), np.isinf(m_j))
        fin = np.isfinite(m_j)
        if fin.any():
            assert _err(m_c[fin], m_j[fin]) < REF_TOL
    for got, want in zip(final, final_j):
        assert _err(got, want) < REF_TOL


@pytest.mark.parametrize("S,dh,chunk", [(64, 32, 16), (96, 16, 32)])
def test_phases_match_the_pallas_kernel_zero_state(S, dh, chunk):
    xs_np, st_np = _inputs(2, 2, S, dh, seed=S + dh, state="zero")
    h, _, (C, n, m) = _phases(_torch(xs_np), _torch(st_np), chunk)
    h_p, (C_p, n_p, m_p) = pallas_mlstm_chunk(
        *(jnp.asarray(a) for a in xs_np), chunk=chunk, interpret=True)
    assert _err(h, h_p) < REF_TOL
    assert _err(C, C_p) < REF_TOL
    assert _err(n, n_p) < REF_TOL
    # the Pallas kernel starts m at -1e30 where the port takes -inf; both
    # end at the last chunk's own maximum
    assert _err(m, m_p) < REF_TOL
