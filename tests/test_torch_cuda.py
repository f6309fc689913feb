"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one.  They import no JAX,
so they run where only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-4 of the output's scale, max(1, max |plain|): both sides
sum at most L*dh f32 products per element, in different orders.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
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
