"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one.  They import no JAX,
so they run where only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances.  mLSTM: 1e-4 of the output's scale, max(1, max |plain|): both
sides sum at most L*dh f32 products per element, in different orders.
Attention, absolute on the rows with q_pos >= 0 (the others are padding
no caller reads): 3e-2 in bf16, the reference's kernel-test tolerance,
since the plain version rounds the probabilities to bf16 and the kernel
keeps them in f32; 1e-4 in f32, where only the order of the sums differs.
The tensor-core layout is also held per element to the f32 plain version
on the inputs upcast (2^-7 of |ref| + 5e-4: one bf16 rounding of the
output, doubled, and the f32 sums), as ``chip_smoke.py`` holds it.

The cases of the layouts' edges assert the layout each call took: mLSTM
``one_step`` (S = 1) or ``chunk_parallel``; attention ``wgmma`` (bf16,
dh 64/128/256, Tq > 1), ``decode`` or ``fma``.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import KERNEL as FLASH
from repro_torch.kernels.mlstm_chunk import KERNEL

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(got, want):
    d = (got.double() - want.double()).abs().max().item()
    return d / max(1.0, want.double().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,dh,chunk,state", [
    (1, 4, 4096, 256, 256, "zero"),    # full-width prefill chunk
    (1, 4, 4096, 256, 256, "random"),
    (4, 4, 1, 256, 256, "random"),     # decode over 4 slots
    (4, 4, 1, 256, 256, "m_inf"),      # decode into a fresh slot
    (1, 4, 300, 256, 256, "random"),   # S % chunk != 0: L = S
    (2, 4, 24, 16, 8, "random"),       # the reduced config's widths
    (2, 3, 70, 48, 32, "random"),      # dh not a multiple of the tile
])
def test_mlstm_chunk_kernel_matches_plain(cuda, B, H, S, dh, chunk, state):
    _check_mlstm(cuda, B, H, S, dh, chunk, state)


def _check_mlstm(cuda, B, H, S, dh, chunk, state):
    gen = torch.Generator(device=cuda).manual_seed(S + dh)
    q, k, v = (torch.randn((B, H, S, dh), generator=gen, device=cuda)
               for _ in range(3))
    li = 0.5 * torch.randn((B, H, S), generator=gen, device=cuda)
    lf = F.logsigmoid(torch.randn((B, H, S), generator=gen, device=cuda) + 2)
    st = (torch.randn((B, H, dh, dh), generator=gen, device=cuda),
          torch.randn((B, H, dh), generator=gen, device=cuda),
          torch.randn((B, H), generator=gen, device=cuda))
    if state == "zero":
        st = (st[0].zero_(), st[1].zero_(), st[2].fill_(float("-inf")))
    elif state == "m_inf":
        st[2].fill_(float("-inf"))
    before = KERNEL.launches
    h, st_k = KERNEL(q, k, v, li, lf, st, chunk=chunk)
    h_r, st_r = ref.mlstm_chunk_ref(q, k, v, li, lf, st, chunk=chunk)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert _err(h, h_r) < TOL
    for got, want in zip(st_k, st_r):
        assert _err(got, want) < TOL
    return KERNEL.last_layout


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,dh,chunk,state", [
    (1, 2, 64, 64, 64, "random"),      # one chunk
    (1, 2, 128, 64, 64, "random"),     # two chunks
    (2, 2, 256, 32, 16, "m_inf"),      # 16 chunks from m = -inf
    (1, 3, 100, 48, 32, "random"),     # S % chunk != 0: one chunk, dh 48
    (2, 2, 48, 16, 16, "zero"),        # dh 16, three chunks
    (1, 2, 192, 64, 96, "random"),     # chunks of 96 rows: 64 + 32
    (1, 2, 40, 64, 1, "random"),       # chunks of one step
    (3, 5, 1, 48, 256, "random"),      # S = 1 at B*H = 15, dh 48
    (2, 2, 1, 16, 256, "m_inf"),       # S = 1 into a fresh slot, dh 16
])
def test_mlstm_chunk_layouts(cuda, B, H, S, dh, chunk, state):
    layout = _check_mlstm(cuda, B, H, S, dh, chunk, state)
    assert layout == ("one_step" if S == 1 else "chunk_parallel")


def _ring_case(B, W, C, fill, dev):
    """k_pos of a W-slot ring holding fill[b] tokens (wrapped past W, -1
    where empty) followed by a chunk of C tokens, and the chunk's q_pos;
    row 0's chunk ends in two padding tokens when C > 2, and a row whose
    fill is None is idle (q_pos -1)."""
    k_pos = torch.full((B, W + C), -1, dtype=torch.int32)
    q_pos = torch.zeros((B, C), dtype=torch.int32)
    for b in range(B):
        n = fill[b] or 0
        for p in range(max(0, n - W), n):
            k_pos[b, p % W] = p
        q_pos[b] = torch.arange(n, n + C)
        k_pos[b, W:] = q_pos[b]
        if fill[b] is None:
            q_pos[b] = -1
            k_pos[b, W:] = -1
    if C > 2:
        q_pos[0, -2:] = -1
        k_pos[0, -2:] = -1
    return q_pos.to(dev), k_pos.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,C,fill,window,Hq,Hkv,dh,dtype", [
    (2, 64, 64, (0, 40), 64, 8, 4, 256, torch.bfloat16),      # empty slots
    (2, 64, 96, (100, 300), 64, 8, 4, 256, torch.bfloat16),   # wrapped ring
    (2, 128, 130, (70, 0), 1 << 30, 8, 4, 256, torch.bfloat16),  # global
    (3, 64, 1, (0, 63, 500), 64, 8, 4, 256, torch.bfloat16),  # decode Tq=1
    (3, 200, 1, (0, 7, 199), 1 << 30, 8, 4, 256, torch.bfloat16),
    (3, 300, 1, (299, None, 40), 1 << 30, 8, 1, 128, torch.bfloat16),
    (2, 40, 1, (90, 3), 16, 16, 1, 64, torch.float32),   # 16 heads per KV
    (2, 24, 1, (30, None), 8, 4, 4, 16, torch.float32),
    (2, 8, 8, (5, 21), 8, 4, 4, 16, torch.float32),           # reduced widths
    (2, 32, 70, (9, 50), 16, 6, 3, 64, torch.float32),
])
def test_flash_attention_kernel_matches_plain(cuda, B, W, C, fill, window,
                                              Hq, Hkv, dh, dtype):
    gen = torch.Generator(device=cuda).manual_seed(W + C + dh)
    q = torch.randn((B, C, Hq, dh), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((B, W + C, Hkv, dh), generator=gen,
                        device=cuda).to(dtype) for _ in range(2))
    q_pos, k_pos = _ring_case(B, W, C, fill, cuda)
    before = FLASH.launches
    out = FLASH(q, k, v, q_pos, k_pos, window=window)
    want = ref.attention_ref(q, k, v, q_pos, k_pos, window=window)
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1
    valid = q_pos >= 0
    err = (out[valid].double() - want[valid].double()).abs().max().item()
    assert err < (3e-2 if dtype == torch.bfloat16 else 1e-4)
    assert (out[~valid] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,C,fill,window,Hq,Hkv,dh", [
    (2, 50, 70, (0, 30), 16, 4, 4, 64),        # Tq, Tk off 64; window < tile
    (2, 100, 130, (120, 7), 64, 8, 4, 128),    # 2 heads per KV head, wrapped
    (3, 64, 200, (0, None, 300), 1 << 30, 8, 1, 256),  # 8 per KV, idle row
    (2, 16, 257, (5, 40), 1 << 30, 4, 2, 64),  # a last Q tile of one row
    (2, 1024, 300, (2000, 600), 1024, 8, 4, 256),  # the served local form
])
def test_flash_attention_wgmma_layout(cuda, B, W, C, fill, window, Hq, Hkv,
                                      dh):
    gen = torch.Generator(device=cuda).manual_seed(W + C + dh)
    q = torch.randn((B, C, Hq, dh), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    k, v = (torch.randn((B, W + C, Hkv, dh), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    q_pos, k_pos = _ring_case(B, W, C, fill, cuda)
    out = FLASH(q, k, v, q_pos, k_pos, window=window)
    assert FLASH.last_layout == "wgmma"
    want = ref.attention_ref(q, k, v, q_pos, k_pos, window=window)
    want32 = ref.attention_ref(q.float(), k.float(), v.float(), q_pos, k_pos,
                               window=window)
    torch.cuda.synchronize()
    valid = q_pos >= 0
    got = out[valid].float()
    assert (got - want[valid].float()).abs().max().item() < 3e-2
    w32 = want32[valid]
    assert ((got - w32).abs() / (2.0 ** -7 * w32.abs() + 5e-4)).max() <= 1.0
    assert (out[~valid] == 0).all()
    assert FLASH.layout(torch.float32, dh, C, Hq, Hkv) == "fma"
    assert FLASH.layout(torch.bfloat16, dh, 1, Hq, Hkv) == "decode"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_serve_step_never_waits_for_the_card(cuda, mode):
    """A decode dispatch of the reduced Gemma enqueues its work without a
    host round trip (a synchronising call raises under the sync debug
    mode), so the host can run ahead of the card."""
    import numpy as np

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.serve import Engine, Request
    eng = Engine(reduced(get_config("gemma3-4b")), slots=3, max_len=32,
                 block_size=8, cache_mode=mode, device=cuda)
    eng.load(eng.model.init(seed=0))
    for rid, n in enumerate((5, 9)):
        assert eng.admit(Request(rid=rid, prompt=np.arange(n),
                                 max_new_tokens=4))
    eng.step()                                  # the chunk tick
    tok = torch.ones((3, 1), dtype=torch.long, device=cuda)
    starts = torch.tensor([5, 9, 0], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([1, 1, 0], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = eng.model.serve_step(eng.params, tok, starts, lengths,
                                         eng.cache)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(logits[:2]).all()
