"""The port's attention (``kernels/ref.py::attention_ref``, reached through
``kernels/ops.py::attention`` on the CPU) against the reference.

1. Against ``repro.models.layers.attention`` with explicit positions: empty
   (-1) cache slots, wrapped rings, window 8 and GLOBAL_WINDOW, GQA,
   Tq = 1, query chunking.
2. With aligned positions (q_pos = k_pos = 0..S-1) against the reference's
   Pallas kernel ``flash_attention`` in interpret mode, over the six
   ``FLASH_CASES`` of ``tests/test_kernels.py`` (window 0 there means
   unbounded, GLOBAL_WINDOW here).

Tolerances, absolute: 3e-5 in f32 and 3e-2 in bf16, the reference's own
kernel-test tolerances (``tests/test_kernels.py:34``).  Against the XLA
path both sides round the probabilities to v's dtype and sum f32 products
in other orders; against the Pallas kernel, which keeps the probabilities
in f32, bf16 differs by the probabilities' rounding (2^-8 relative).

The CUDA kernel itself is held against the plain version on the card in
test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.layers import attention as jax_attention
from repro_torch.configs.base import GLOBAL_WINDOW
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import KERNEL
from repro_torch.models import layers

TOL = {"f32": 3e-5, "bf16": 3e-2}
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}

# the reference's FLASH_CASES: (Sq, Sk, Hq, Hkv, dh, window, dtype)
FLASH_CASES = [
    (128, 128, 4, 2, 64, 0, "f32"),
    (256, 256, 8, 8, 128, 0, "bf16"),
    (256, 256, 4, 1, 64, 64, "f32"),
    (128, 128, 2, 2, 128, 32, "bf16"),
    (128, 128, 6, 3, 64, 0, "f32"),
    (64, 64, 2, 1, 128, 16, "f32"),
]


def _qkv(B, Tq, Tk, Hq, Hkv, dh, dtype, seed):
    """q/k/v drawn with numpy, given to both sides in ``dtype``."""
    rng = np.random.default_rng(seed)
    _, jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Tq, Hq, dh), (B, Tk, Hkv, dh), (B, Tk, Hkv, dh))]
    jx = [jnp.asarray(a).astype(jdt) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in jx]
    return jx, tx


def _ring_positions(B, W, C, fill):
    """k_pos of a W-slot ring that holds ``fill[b]`` tokens (position p at
    slot p % W, -1 where empty, wrapped once fill > W) followed by a chunk
    of C tokens, and the chunk's q_pos."""
    k_pos = np.full((B, W + C), -1, np.int32)
    q_pos = np.zeros((B, C), np.int32)
    for b in range(B):
        n = fill[b]
        for p in range(max(0, n - W), n):
            k_pos[b, p % W] = p
        q_pos[b] = np.arange(n, n + C)
        k_pos[b, W:] = q_pos[b]
    return q_pos, k_pos


def _err(got, want):
    return float(np.max(np.abs(np.asarray(got.float(), np.float64)
                               - np.asarray(want.astype(jnp.float32),
                                            np.float64))))


@pytest.mark.parametrize("case", [
    # (name, B, W, C, fill, window, Hq, Hkv, q_chunk)
    ("empty_slots_window8", 2, 16, 8, (0, 5), 8, 4, 2, 0),
    ("wrapped_ring_window8", 2, 8, 8, (13, 21), 8, 4, 2, 0),
    ("wrapped_ring_global", 2, 8, 8, (13, 21), GLOBAL_WINDOW, 4, 4, 0),
    ("decode_tq1_window8", 3, 8, 1, (0, 7, 30), 8, 4, 2, 0),
    ("decode_tq1_global", 3, 32, 1, (0, 7, 30), GLOBAL_WINDOW, 8, 4, 0),
    ("query_chunks", 2, 16, 16, (3, 20), 8, 4, 2, 4),
], ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_reference_with_positions(case, dtype):
    _, B, W, C, fill, window, Hq, Hkv, q_chunk = case
    dh = 16
    q_pos, k_pos = _ring_positions(B, W, C, fill)
    if C > 1:               # pad the end of row 0's chunk, as ticks do
        q_pos[0, -2:] = -1
        k_pos[0, -2:] = -1
    (jq, jk, jv), (tq, tk, tv) = _qkv(B, C, W + C, Hq, Hkv, dh, dtype,
                                      seed=W * C + Hq)
    want = jax_attention(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(k_pos),
                         window=window, q_chunk=q_chunk)
    got = ops.attention(tq, tk, tv, torch.from_numpy(q_pos),
                        torch.from_numpy(k_pos), window=window,
                        q_chunk=q_chunk)
    assert got.dtype == tv.dtype and got.shape == (B, C, Hq, dh)
    valid = q_pos >= 0      # padded rows are read by no caller
    assert _err(got[torch.from_numpy(valid)], want[valid]) < TOL[dtype]


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,dh,win,dtype", FLASH_CASES)
def test_plain_matches_pallas_kernel(Sq, Sk, Hq, Hkv, dh, win, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, Sq, Sk, Hq, Hkv, dh, dtype,
                                      seed=Sq + Hq + dh)
    want = pallas_flash(jq, jk, jv, causal=True, window=win, block_q=64,
                        block_k=64, interpret=True)
    q_pos = torch.arange(Sq, dtype=torch.int32).expand(2, Sq)
    k_pos = torch.arange(Sk, dtype=torch.int32).expand(2, Sk)
    got = ref.attention_ref(tq, tk, tv, q_pos, k_pos,
                            window=win or GLOBAL_WINDOW)
    assert _err(got, want) < TOL[dtype]


def test_non_causal_keeps_every_valid_key():
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 4, 12, 4, 2, 16, "f32", seed=3)
    k_pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    k_pos[1, 7:] = -1
    q_pos = np.zeros((2, 4), np.int32)
    want = jax_attention(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(k_pos),
                         causal=False)
    got = layers.attention(tq, tk, tv, torch.from_numpy(q_pos),
                           torch.from_numpy(k_pos), causal=False)
    assert _err(got, want) < TOL["f32"]


def test_cpu_dispatch_uses_plain_version_and_wrapper_rejects_cpu():
    _, (tq, tk, tv) = _qkv(1, 4, 8, 2, 1, 16, "f32", seed=0)
    q_pos = torch.arange(4, 8, dtype=torch.int32)[None]
    k_pos = torch.arange(8, dtype=torch.int32)[None]
    before = KERNEL.launches
    got = ops.attention(tq, tk, tv, q_pos, k_pos, window=8)
    want = ref.attention_ref(tq, tk, tv, q_pos, k_pos, window=8)
    assert torch.equal(got, want)
    assert KERNEL.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        KERNEL(tq, tk, tv, q_pos, k_pos, window=8)
    with pytest.raises(ValueError, match="no path"):
        ops.attention(tq.to("meta"), tk.to("meta"), tv.to("meta"),
                      q_pos.to("meta"), k_pos.to("meta"))
