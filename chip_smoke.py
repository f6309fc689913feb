#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then nonzero):

1. build the mLSTM chunk kernel from ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a;
2. hold the kernel against its plain PyTorch version on the card at the
   shapes serving gives it: a 4096-token prefill (chunk 256) from a zero
   and from a random state, a 4-slot decode step from a random state and
   from m = -inf, a one-token step at batch 1 (the token-by-token prefill
   of short prompts), and a 300-token call (one chunk of L = S); time both
   versions with CUDA events and compute the card's bound for the work;
3. serve xLSTM-350M at its published widths (random weights from a seed)
   through ``repro_torch.serve.Engine``: one 4104-token prompt and three
   short ones, 16 greedy tokens each, with the kernel's launch counts set
   to 0 just before and read just after; every (batch, length) the run
   launched must be one that phase 2 checked;
4. time one mLSTM and one sLSTM block on a 4096-token prefill;
5. check the card's path against the CPU's plain path on the reduced
   config (f32 weights): prefill and decode logits must agree.

The last lines are the kernels' JSON record, the card's name and power
limit from nvidia-smi, and the result line.  Without a CUDA device, or
without the repository's ``src/`` beside it, the script exits nonzero
before printing any result.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# kernel vs plain version: 1e-4 of the output's scale (f32 sums of up to
# L*dh products taken in different orders)
KERNEL_TOL = 1e-4
# card vs CPU on the reduced model with f32 weights: f32 rounding through
# 4 blocks and the output projection
MODEL_TOL = 1e-4
TOKENS = 16
SLOTS = 4
LONG_PROMPT = 4104          # one 4096-token chunk, then 8 single steps


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    d = (got.double() - want.double()).abs().max().item()
    return d / max(1.0, want.double().abs().max().item())


def cuda_ms(torch, fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed with
    CUDA events after ``flush`` has evicted the L2 cache."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def mlstm_bound(B, H, S, dh, L):
    """Least time on the card: operations (causal halves of q k^T and w v,
    plus q C and k^T v, per chunk and head) at the fp32 rate, against bytes
    (q, k, v, li, lf and the state read once; h and the state written once)
    at the memory rate."""
    flops = B * H * (S // L) * (2 * dh * L * (L + 1) + 4 * L * dh * dh)
    state = B * H * (dh * dh + dh + 1)
    nbytes = 4 * (4 * B * H * S * dh + 2 * B * H * S + 2 * state)
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def kernel_phase(torch, F, KERNEL, ref):
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_

    def inputs(B, H, S, dh, state):
        q, k, v = (torch.randn((B, H, S, dh), generator=gen, device=dev)
                   for _ in range(3))
        li = 0.5 * torch.randn((B, H, S), generator=gen, device=dev)
        lf = F.logsigmoid(torch.randn((B, H, S), generator=gen, device=dev)
                          + 2.0)
        if state == "zero":
            st = (torch.zeros((B, H, dh, dh), device=dev),
                  torch.zeros((B, H, dh), device=dev),
                  torch.full((B, H), float("-inf"), device=dev))
        else:
            st = (torch.randn((B, H, dh, dh), generator=gen, device=dev),
                  torch.randn((B, H, dh), generator=gen, device=dev),
                  torch.randn((B, H), generator=gen, device=dev))
            if state == "m_inf":
                st[2].fill_(float("-inf"))
        return (q, k, v, li, lf), st

    cases = [  # (B, H, S, dh, chunk, state, timing iterations)
        (1, 4, 4096, 256, 256, "zero", 10),
        (1, 4, 4096, 256, 256, "random", 3),
        (SLOTS, 4, 1, 256, 256, "random", 50),
        (SLOTS, 4, 1, 256, 256, "m_inf", 3),
        (1, 4, 1, 256, 256, "random", 50),
        (1, 4, 300, 256, 256, "random", 10),
    ]
    rows = []
    for B, H, S, dh, chunk, state, iters in cases:
        xs, st = inputs(B, H, S, dh, state)
        h, st_k = KERNEL(*xs, st, chunk=chunk)
        h_r, st_r = ref.mlstm_chunk_ref(*xs, st, chunk=chunk)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip((h, *st_k), (h_r, *st_r))]
        abs_err = max((a - b).abs().max().item()
                      for a, b in zip((h, *st_k), (h_r, *st_r)))
        check(all(torch.isfinite(t).all().item() for t in (h, *st_k[:2])),
              f"kernel output not finite at {(B, H, S, dh)} {state}")
        check(max(errs) < KERNEL_TOL,
              f"kernel disagrees with plain version at {(B, H, S, dh)} "
              f"{state}: errors h/C/n/m {errs}")
        L = ref.chunk_len(S, chunk)
        ms = cuda_ms(torch, lambda: KERNEL(*xs, st, chunk=chunk), iters,
                     flush)
        plain_ms = cuda_ms(
            torch, lambda: ref.mlstm_chunk_ref(*xs, st, chunk=chunk),
            iters, flush)
        bound_ms, bound_by, flops, nbytes = mlstm_bound(B, H, S, dh, L)
        row = dict(shape=[B, H, S, dh], L=L, state=state,
                   rel_err=max(errs), max_abs_err=abs_err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   flops=flops, bytes=nbytes)
        print("[kernel] mlstm_chunk " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def serve_phase(torch, np, KERNEL, get_config, Engine, Request):
    cfg = get_config("xlstm-350m")
    rng = np.random.default_rng(0)
    lengths = [LONG_PROMPT] + [int(n) for n in rng.integers(8, 65, size=3)]
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n),
                    max_new_tokens=TOKENS) for i, n in enumerate(lengths)]
    engine = Engine(cfg, slots=SLOTS, max_len=max(lengths) + TOKENS,
                    seed=0, device=DEVICE)
    engine.load(engine.model.init(seed=0))
    engine.run_to_completion([Request(rid=99, prompt=np.arange(8),
                                      max_new_tokens=2)])   # warm-up
    torch.cuda.synchronize()
    KERNEL.reset_counts()
    t0 = time.perf_counter()
    res = engine.run_to_completion(reqs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches, by_shape = KERNEL.launches, dict(KERNEL.by_shape)

    check(not res.truncated and sorted(res) == list(range(len(lengths))),
          f"not every request completed: {sorted(res)}")
    for rid, toks in res.items():
        check(len(toks) == TOKENS, f"request {rid} got {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"request {rid} produced out-of-vocabulary tokens")
    n_mlstm = cfg.num_layers // len(cfg.xlstm_pattern)
    prefill = by_shape.get((1, cfg.prefill_chunk), 0)
    decode = by_shape.get((SLOTS, 1), 0)
    check(prefill >= n_mlstm,
          f"the 4096-token prefill launched the kernel {prefill} times")
    check(decode >= n_mlstm,
          f"decode ticks launched the kernel {decode} times")
    ttfts = sorted(m["ttft_s"] for m in res.metrics.values())
    p95 = ttfts[min(len(ttfts) - 1, int(0.95 * len(ttfts)))]
    # time per generated token after the first, per request
    gaps = sorted((m["done_s"] - m["arrival_s"] - m["ttft_s"])
                  / (m["tokens"] - 1) for m in res.metrics.values())
    tokens = sum(len(v) for v in res.values())
    print("[serve] " + json.dumps(dict(
        arch=cfg.name, slots=SLOTS, prompt_lengths=lengths,
        new_tokens=TOKENS, completed=len(res), tokens=tokens,
        seconds=elapsed, tokens_per_s=tokens / elapsed, ttft_s=ttfts,
        p95_ttft_s=p95, s_per_token_after_first=gaps)), flush=True)
    print("[kernels] " + json.dumps(dict(
        mlstm_chunk=launches,
        by_batch_and_length={f"{b}x{s}": n
                             for (b, s), n in sorted(by_shape.items())})),
          flush=True)
    return launches, by_shape, engine


def prefill_breakdown(torch, engine, ssm):
    """Device time of one mLSTM and one sLSTM block on a 4096-token prompt
    at batch 1, from a zero state (host clock around synchronised work)."""
    cfg, params = engine.cfg, engine.params
    x = torch.randn((1, cfg.prefill_chunk, cfg.d_model), device=DEVICE
                    ).to(torch.bfloat16)
    out = {}
    for name, fwd, p, kw in (
            ("mlstm", ssm.mlstm_forward, params["layers"][0],
             dict(chunk=cfg.mlstm_chunk)),
            ("slstm", ssm.slstm_forward, params["layers"][1], {})):
        with torch.no_grad():
            fwd(p, x, None, heads=cfg.num_heads, dh=cfg.head_dim, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, _ = fwd(p, x, None, heads=cfg.num_heads, dh=cfg.head_dim, **kw)
            torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), f"{name} block output not finite")
        out[f"{name}_block_s"] = time.perf_counter() - t0
    n = cfg.num_layers // 2
    total = n * (out["mlstm_block_s"] + out["slstm_block_s"])
    out["slstm_share_of_blocks"] = n * out["slstm_block_s"] / total
    print("[prefill] " + json.dumps(out), flush=True)


def reduced_parity(torch, get_config, reduced, Model):
    cfg = reduced(get_config("xlstm-350m"))
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device=DEVICE)
    params = cpu.init(seed=1)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.float().to(dev)

    p_cpu, p_gpu = to(params, "cpu"), to(params, DEVICE)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    lg_c, cache_c = cpu.prefill(p_cpu, prompt)
    lg_g, cache_g = gpu.prefill(p_gpu, prompt.to(DEVICE))
    errs = [rel_err(lg_g.cpu(), lg_c)]
    for step in range(3):
        tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=g)
        pos = torch.full((2,), 16 + step, dtype=torch.int32)
        lg_c, cache_c = cpu.decode_step(p_cpu, tok, pos, cache_c)
        lg_g, cache_g = gpu.decode_step(p_gpu, tok.to(DEVICE), pos.to(DEVICE),
                                        cache_g)
        errs.append(rel_err(lg_g.cpu(), lg_c))
    print(f"[parity] reduced xlstm-350m, card vs CPU logits: max error "
          f"{max(errs):.3e} (tolerance {MODEL_TOL})", flush=True)
    check(max(errs) < MODEL_TOL, f"card and CPU disagree: {errs}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: the port's package is not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config, reduced
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import MLSTM_CHUNK as KERNEL
    from repro_torch.models import ssm
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    KERNEL.load()
    print(f"[build] mlstm_chunk built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}", flush=True)

    rows = kernel_phase(torch, F, KERNEL, ref)
    launches, by_shape, engine = serve_phase(torch, np, KERNEL, get_config,
                                             Engine, Request)
    checked = {(r["shape"][0], r["shape"][2]) for r in rows}
    check(set(by_shape) <= checked,
          f"serving launched the kernel at (batch, length) "
          f"{sorted(set(by_shape) - checked)}, which phase 2 did not check")
    prefill_breakdown(torch, engine, ssm)
    reduced_parity(torch, get_config, reduced, Model)

    main_row = rows[0]       # the prefill shape the engine sends
    print(json.dumps({"kernels": [{
        "name": "mlstm_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk.py:103",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
