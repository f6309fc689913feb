#!/usr/bin/env python3
"""Where the time of the tensor-core (wgmma) attention layout goes: build
stripped copies of ``csrc/flash_attention.cu`` and time each beside the
full kernel at the Gemma-3-4B serve's bf16 chunk shapes, on one card.

    python3 scripts/attention_variants.py

Variants (each a text edit of the source, written under the git-ignored
``src/repro_torch/kernels/build/variants/``; their outputs are not
checked):

- ``full``: the kernel as it is;
- ``no_pv``: without the P V products;
- ``one_pv``: P V with the hi term of P only (one bf16 term, not two);
- ``no_qk``: without the Q K^T products;
- ``softmax_only``: neither product: loads, masks and the online softmax;
- ``loads_only``: every consumer treats every tile as dead: the producer's
  reads of positions, the TMA loads of Q, K and V, the barriers and the
  output's stores.

Prints one JSON line per (shape, variant, turn): ``cold_ms`` (CUDA events
after an L2 flush, as ``chip_smoke.cuda_ms``) and ``warm_ms`` (device time
of back-to-back calls, as ``chip_smoke.device_ms``), then a summary line
with the mean of the two turns.
"""
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(1, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

PV_LOOP = "for (int kk = 0; kk < 4; ++kk) {\n          const uint64_t dv"
QK_LOOP = "for (int kk = 0; kk < DH / 16; ++kk) {"
LO_TERM = "wgmma_rs<DH>(o, lo[4 * kk]"
LIVE = "const bool live = wmax >= 0 &&"


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"attention_variants: the source no longer has "
                         f"{old!r}; update the variant edits")
    return text.replace(old, new)


def variants(src: str) -> dict:
    no_pv = _edit(src, PV_LOOP, PV_LOOP.replace("kk < 4", "kk < 0"))
    return {
        "full": src,
        "no_pv": no_pv,
        "one_pv": _edit(src, LO_TERM, "if (0) " + LO_TERM),
        "no_qk": _edit(src, QK_LOOP, QK_LOOP.replace("DH / 16", "0")),
        "softmax_only": _edit(no_pv, QK_LOOP,
                              QK_LOOP.replace("DH / 16", "0")),
        "loads_only": _edit(src, LIVE, LIVE.replace("wmax >= 0",
                                                    "false && wmax >= 0")),
    }


def load(path) -> "fa.FlashAttentionKernel":
    """A wrapper around the library built from ``path``."""
    kern = fa.FlashAttentionKernel()
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_workspace_bytes.argtypes = [ctypes.c_int] * 6
    lib.flash_attention_workspace_bytes.restype = ctypes.c_size_t
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    lib.flash_attention_layout.argtypes = [ctypes.c_int] * 5
    lib.flash_attention_layout.restype = ctypes.c_int
    lib.flash_attention_init.restype = ctypes.c_int
    if lib.flash_attention_init() != 0:
        raise SystemExit(f"attention_variants: init failed for {path}")
    kern._lib = lib
    return kern


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA device", file=sys.stderr)
        return 1
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in variants(fa.SOURCE.read_text()).items():
        paths[name] = out / f"flash_{name}.cu"
        paths[name].write_text(text)
    with ThreadPoolExecutor(len(paths)) as pool:   # one nvcc for each
        libs = dict(zip(paths, pool.map(
            lambda n: build.build_library(paths[n])[0], paths)))
    kerns = {name: load(path) for name, path in libs.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    Hq, Hkv, dh = cs.GEMMA_HEADS
    summary = {}
    for kind, state in (("global", "empty"), ("global", "wrapped"),
                        ("local", "empty"), ("local", "wrapped")):
        window = cs.WINDOW if kind == "local" else ref.GLOBAL_WINDOW
        q_pos, k_pos = cs.attn_positions(torch, kind, state, dev)
        (B, Tq), Tk = q_pos.shape, k_pos.shape[1]
        q = torch.randn((B, Tq, Hq, dh), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k, v = (torch.randn((B, Tk, Hkv, dh), generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
        for turn in range(2):
            for name, kern in kerns.items():
                def fn(kern=kern):
                    return kern(q, k, v, q_pos, k_pos, window=window)
                row = dict(case=f"{kind}-{state}", variant=name, turn=turn,
                           cold_ms=cs.cuda_ms(torch, fn, 10, flush),
                           warm_ms=cs.device_ms(torch, fn)[0])
                print(json.dumps(row), flush=True)
                s = summary.setdefault(row["case"], {}).setdefault(
                    name, {"cold_ms": 0.0, "warm_ms": 0.0})
                s["cold_ms"] += row["cold_ms"] / 2
                s["warm_ms"] += row["warm_ms"] / 2
    print(json.dumps({"card": cs.nvidia_smi(), "mean_of_two_turns": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
