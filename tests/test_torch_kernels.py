"""The port's chunkwise-mLSTM kernel module against the reference.

On the CPU ``ops.mlstm_chunk`` runs the plain chunk loop; it is held
against the reference's Pallas kernel in interpret mode (zero state) and
against the reference's ``_mlstm_chunk`` loop with a carried state.  The
CUDA kernel itself is held against the plain loop on the card in
test_torch_cuda.py.

Tolerance: 1e-4 of the output's scale, max(1, max |reference|).  Both
sides sum at most L*dh f32 products per element, in different orders;
1e-4 leaves about two orders of magnitude above that rounding, as in the
reference's own kernel test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk import mlstm_chunk as pallas_mlstm_chunk
from repro.models.ssm import _mlstm_chunk
from repro_torch.kernels import ops, ref
from repro_torch.kernels.mlstm_chunk import KERNEL

TOL = 1e-4


def _err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


def _inputs(B, H, S, dh, seed, state="zero"):
    """q/k/v/li/lf as the reference's kernel test draws them, and a
    (C, n, m) state: zero (m = -inf), random, or random with m = -inf."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, dh)).astype(np.float32)
               for _ in range(3))
    li = (0.5 * rng.standard_normal((B, H, S))).astype(np.float32)
    lf = -np.log1p(np.exp(-(rng.standard_normal((B, H, S)) + 2.0)))
    lf = lf.astype(np.float32)
    if state == "zero":
        C = np.zeros((B, H, dh, dh), np.float32)
        n = np.zeros((B, H, dh), np.float32)
        m = np.full((B, H), -np.inf, np.float32)
    else:
        C = rng.standard_normal((B, H, dh, dh)).astype(np.float32)
        n = rng.standard_normal((B, H, dh)).astype(np.float32)
        m = rng.standard_normal((B, H)).astype(np.float32)
        if state == "m_inf":
            m[:] = -np.inf
    return (q, k, v, li, lf), (C, n, m)


def _torch(arrays, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _jax_loop(xs, state, chunk):
    """The reference's mlstm_forward chunk loop over ``_mlstm_chunk``."""
    q, k, v, li, lf = (jnp.asarray(a) for a in xs)
    st = tuple(jnp.asarray(a) for a in state)
    S = q.shape[2]
    L = min(chunk, S)
    L = S if S % L else L
    hs = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        h, st = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                             li[:, :, sl], lf[:, :, sl], st)
        hs.append(h)
    return np.asarray(jnp.concatenate(hs, axis=2)), [np.asarray(a) for a in st]


@pytest.mark.parametrize("S,dh,chunk", [(256, 64, 64), (128, 32, 32),
                                        (256, 128, 128)])
def test_plain_matches_pallas_kernel_zero_state(S, dh, chunk):
    xs, st = _inputs(2, 3, S, dh, seed=S + dh)
    h_p, (C_p, n_p, m_p) = pallas_mlstm_chunk(
        *(jnp.asarray(a) for a in xs), chunk=chunk, interpret=True)
    h, (C, n, m) = ops.mlstm_chunk(*_torch(xs), _torch(st), chunk=chunk)
    assert _err(h, h_p) < TOL
    assert _err(C, C_p) < TOL
    assert _err(n, n_p) < TOL
    # the Pallas kernel starts m at -1e30 where the port takes -inf; both
    # end at the chunk's own maximum
    assert _err(m, m_p) < TOL


@pytest.mark.parametrize("B,S,dh,chunk,state", [
    (2, 64, 16, 16, "random"),       # carried state, 4 chunks
    (2, 64, 16, 16, "m_inf"),        # a fresh slot: m = -inf, C/n nonzero
    (4, 1, 32, 256, "random"),       # decode: one step per slot
    (2, 40, 16, 16, "random"),       # S % chunk != 0 -> one chunk of L = S
])
def test_plain_matches_reference_chunk_loop(B, S, dh, chunk, state):
    xs, st = _inputs(B, 3, S, dh, seed=7 * S + dh, state=state)
    h_r, st_r = _jax_loop(xs, st, chunk)
    h, st_p = ops.mlstm_chunk(*_torch(xs), _torch(st), chunk=chunk)
    assert _err(h, h_r) < TOL
    for got, want in zip(st_p, st_r):
        assert _err(got, want) < TOL


def test_cpu_dispatch_uses_plain_version_and_wrapper_rejects_cpu():
    xs, st = _inputs(1, 2, 8, 16, seed=0)
    before = KERNEL.launches
    h, _ = ops.mlstm_chunk(*_torch(xs), _torch(st), chunk=4)
    h_ref, _ = ref.mlstm_chunk_ref(*_torch(xs), _torch(st), chunk=4)
    assert torch.equal(h, h_ref)
    assert KERNEL.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        KERNEL(*_torch(xs), _torch(st), chunk=4)
