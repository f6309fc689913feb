#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then nonzero):

1. build both kernels from ``src/repro_torch/kernels/csrc`` with nvcc for
   sm_90a, one nvcc for each source, started together;
2. hold the mLSTM chunk kernel against its plain PyTorch version on the
   card at the shapes serving gives it: a 4096-token prefill (chunk 256)
   from a zero and from a random state, a 4-slot decode step from a random
   state and from m = -inf, a one-token step at batch 1 (the
   token-by-token prefill of short prompts), and a 300-token call (one
   chunk of L = S); check that S = 1 took the one-step layout and every
   longer call the chunk-parallel one; time both versions with CUDA
   events, the kernel's device time with the profiler, and compute the
   card's bound for the work;
3. serve xLSTM-350M at its published widths (random weights from a seed)
   through ``repro_torch.serve.Engine``: one 4104-token prompt and three
   short ones, 16 greedy tokens each, with the kernel's launch counts set
   to 0 just before and read just after; every (batch, length) the run
   launched must be one that phase 2 checked;
4. time one mLSTM and one sLSTM block on a 4096-token prefill;
5. check the card's path against the CPU's plain path on the reduced
   xLSTM config (f32 weights): prefill and decode logits must agree;
6. hold the flash-attention kernel against its plain version at the shapes
   the Gemma-3-4B serve gives it (bf16, 8 query heads over 4 KV heads,
   dh 256): a (4, 4096) chunk tick over a local entry (1024-slot ring ++
   chunk, window 1024) and over a global entry (paged logical length ++
   chunk), each from an empty cache and from one partly filled with
   wrapped positions, and a (4, 1) decode tick over each entry kind; hold
   the bf16 kernel per element, and the f32 kernel on the inputs upcast,
   tightly against the plain version in f32 at each of them; check that
   every bf16 chunk case took the tensor-core (wgmma) layout and every
   decode case the decode layout; time the kernel (and its device time
   with the profiler), the plain version and one call of PyTorch's
   ``scaled_dot_product_attention`` (the yardstick; the port never calls
   it) and compute the card's bound;
7. serve Gemma-3-4B at its published widths (random bf16 weights from
   seed 0) in ``paged`` mode with the ``conservative`` policy: 4 slots,
   max_len 5120, block size 16, prompts of 5000, 56, 44 and 37 tokens, 16
   greedy tokens each; the attention kernel's launches are counted as in
   phase 3, every launched (batch, Tq, Tk) must be one phase 6 checked,
   and every attention layer must have launched it in every tick; then
   profile one chunk tick and four decode ticks of fresh requests;
8. check the reduced Gemma config (f32 weights) on the card against the
   CPU: prefill and decode logits must agree, and ``paged`` and ``dense``
   serving must give the same greedy tokens on the card.

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
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, bf16
# dense on the tensor cores, HBM3
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
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
# flash attention vs plain in bf16: the reference's kernel-test tolerance
# (tests/test_kernels.py), absolute; the plain version rounds the
# probabilities to bf16, the kernel keeps them in f32
ATTN_TOL = 3e-2
# the tight checks at the same shapes, against the plain version on the
# inputs upcast to f32 (probabilities kept in f32, as the kernel keeps
# them): the bf16 kernel per element within one bf16 rounding of the
# output (2^-8 of |ref|, doubled) plus 5e-4 for the f32 sums, a tenth of
# what one 32-key tile more or less moves a 1024-key row; the f32 kernel
# within 1e-4 of the output's scale, as the mLSTM kernel is held
ATTN_RTOL_BF16, ATTN_ATOL_BF16 = 2.0 ** -7, 5e-4
ATTN_TOL_F32 = 1e-4
# reduced Gemma, card vs CPU with f32 weights: the KV cache is bf16, and in
# decode the CPU's plain version rounds the probabilities and the output
# to it while the kernel keeps the probabilities in f32 (emulated on the
# CPU this moves decode logits by 4e-3 to 7e-3 of scale)
GEMMA_TOL = 3e-2
GEMMA_PROMPTS = (5000, 56, 44, 37)   # 5000 = a 4096-wide chunk tick + 904
GEMMA_MAX_LEN = 5120
GEMMA_CHUNK = 4096                   # the config's prefill_chunk
GEMMA_HEADS = (8, 4, 256)            # query heads, KV heads, head_dim
BLOCK = 16
WINDOW = 1024


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


def _dev_us(e):
    """Device time of a profiler event, in microseconds."""
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


def device_ms(torch, fn, iters: int = 20):
    """The sum of the kernel durations of one call of ``fn``: torch.profiler's
    device events over ``iters`` back-to-back calls (no flush between
    them), divided by ``iters``; where the profiler shows no device time,
    CUDA events around 100 back-to-back calls.  Returns (ms, source, ms by
    kernel name; empty from events).  Unlike ``cuda_ms`` this leaves out
    the wrapper's host work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {e.key[:60]: _dev_us(e) / 1e3 / iters
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _dev_us(e) > 0}
    if by_name:
        return sum(by_name.values()), "profiler", by_name
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(100):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / 100, "events", {}


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
        layout = KERNEL.last_layout
        h_r, st_r = ref.mlstm_chunk_ref(*xs, st, chunk=chunk)
        torch.cuda.synchronize()
        check(layout == ("one_step" if S == 1 else "chunk_parallel"),
              f"mlstm_chunk took the {layout} layout at {(B, H, S, dh)}")
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
        dev_ms, dev_src, dev_by = device_ms(
            torch, lambda: KERNEL(*xs, st, chunk=chunk))
        plain_ms = cuda_ms(
            torch, lambda: ref.mlstm_chunk_ref(*xs, st, chunk=chunk),
            iters, flush)
        bound_ms, bound_by, flops, nbytes = mlstm_bound(B, H, S, dh, L)
        row = dict(shape=[B, H, S, dh], L=L, state=state, layout=layout,
                   rel_err=max(errs), max_abs_err=abs_err, ms=ms,
                   device_ms=dev_ms, device_ms_from=dev_src,
                   device_ms_by_kernel=dev_by,
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
    by_layout = dict(KERNEL.by_layout)

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
    one_step = sum(n for (_, s), n in by_shape.items() if s == 1)
    check(by_layout == {k: v for k, v in (("one_step", one_step),
                                          ("chunk_parallel",
                                           launches - one_step)) if v},
          f"the serve's mlstm layouts {by_layout} do not follow S")
    print("[kernels] " + json.dumps(dict(
        mlstm_chunk=launches, by_layout=by_layout,
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


def attn_positions(torch, kind: str, state: str, dev):
    """(q_pos, k_pos) int32 of one attention call of the Gemma serve.

    kind: 'local' (a 1024-slot ring) or 'global' (the paged logical
    length).  state: 'empty' (the first chunk tick: every prompt from
    position 0, padded to the 4096-wide tick, nothing cached), 'wrapped'
    (the second chunk tick: the 5000-token prompt's last 904 tokens from
    position 4096 over its cached 0..4095, which the local ring holds
    wrapped; the other rows idle with their prompts cached) or 'decode'
    (every row's 8th generated token, the cache updated first)."""
    C = GEMMA_CHUNK
    W = WINDOW if kind == "local" else GEMMA_MAX_LEN
    if state == "decode":
        q = [[n + 7] for n in GEMMA_PROMPTS]
        cached = [n + 8 for n in GEMMA_PROMPTS]
    elif state == "empty":
        q = [list(range(min(n, C))) for n in GEMMA_PROMPTS]
        cached = [0] * SLOTS
    else:
        q = [list(range(C, GEMMA_PROMPTS[0]))] + [[]] * (SLOTS - 1)
        cached = [C] + list(GEMMA_PROMPTS[1:])
    Tq = 1 if state == "decode" else C
    q_pos = torch.full((SLOTS, Tq), -1, dtype=torch.int32)
    k_cache = torch.full((SLOTS, W), -1, dtype=torch.int32)
    for b in range(SLOTS):
        q_pos[b, :len(q[b])] = torch.tensor(q[b], dtype=torch.int32)
        for p in range(max(0, cached[b] - W), cached[b]):
            k_cache[b, p % W] = p
    k_pos = k_cache if state == "decode" else torch.cat([k_cache, q_pos], 1)
    return q_pos.to(dev), k_pos.to(dev)


def attn_bound(torch, q_pos, k_pos, window, Hq, Hkv, dh):
    """Least time on the card for what these positions need: 4*dh*Hq
    operations for every live (query, key) pair at the bf16 tensor-core
    rate, against the bytes at the memory rate of the valid query rows of
    q and the output, the K and V rows of the keys live for at least one
    valid query of their batch row, each moved once, and the positions."""
    live = n_q = n_k = 0
    for b in range(q_pos.shape[0]):
        valid = q_pos[b] >= 0
        rel = q_pos[b][:, None].long() - k_pos[b][None, :].long()
        ok = valid[:, None] & (k_pos[b] >= 0)[None, :] \
            & (rel >= 0) & (rel < window)
        live += int(ok.sum().item())
        n_q += int(valid.sum().item())
        n_k += int(ok.any(0).sum().item())
    flops = 4 * dh * Hq * live
    nbytes = 2 * (2 * n_q * Hq * dh + 2 * n_k * Hkv * dh) \
        + 4 * (q_pos.numel() + k_pos.numel())
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes,
            live)


def attention_phase(torch, F, FLASH, ref):
    """The flash-attention kernel against its plain version at the Gemma
    serve's shapes.  Returns one row per case, with its (B, Tq, Tk)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    Hq, Hkv, dh = GEMMA_HEADS
    rows = []
    for kind, state, iters in (("local", "empty", 5),
                               ("local", "wrapped", 5),
                               ("global", "empty", 5),
                               ("global", "wrapped", 5),
                               ("local", "decode", 20),
                               ("global", "decode", 20)):
        window = WINDOW if kind == "local" else ref.GLOBAL_WINDOW
        q_pos, k_pos = attn_positions(torch, kind, state, dev)
        (B, Tq), Tk = q_pos.shape, k_pos.shape[1]
        q = torch.randn((B, Tq, Hq, dh), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k, v = (torch.randn((B, Tk, Hkv, dh), generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
        out = FLASH(q, k, v, q_pos, k_pos, window=window)
        layout = FLASH.last_layout
        want = ref.attention_ref(q, k, v, q_pos, k_pos, window=window,
                                 q_chunk=512)
        torch.cuda.synchronize()
        check(layout == ("decode" if Tq == 1 else "wgmma"),
              f"attention took the {layout} layout at {(B, Tq, Tk)} {kind} "
              f"{state}")
        valid = q_pos >= 0
        check(bool(torch.isfinite(out[valid]).all()),
              f"attention output not finite at {(B, Tq, Tk)} {kind} {state}")
        err = (out[valid].float() - want[valid].float()).abs().max().item()
        check(err < ATTN_TOL, f"attention kernel disagrees with the plain "
              f"version at {(B, Tq, Tk)} {kind} {state}: {err}")
        # the tight checks: bf16 kernel per element, and the f32 kernel on
        # the same inputs upcast, against the plain version in f32
        q32, k32, v32 = (t.float() for t in (q, k, v))
        want32 = ref.attention_ref(q32, k32, v32, q_pos, k_pos,
                                   window=window, q_chunk=512)[valid]
        tight_err = ((out[valid].float() - want32).abs()
                     / (ATTN_RTOL_BF16 * want32.abs() + ATTN_ATOL_BF16)
                     ).max().item()
        out32 = FLASH(q32, k32, v32, q_pos, k_pos, window=window)[valid]
        f32_err = rel_err(out32, want32)
        del q32, k32, v32, want32, out32
        check(tight_err <= 1.0, f"bf16 attention kernel off the f32 plain "
              f"version by {tight_err} of its per-element tolerance at "
              f"{(B, Tq, Tk)} {kind} {state}")
        check(f32_err < ATTN_TOL_F32, f"f32 attention kernel disagrees with "
              f"the plain version at {(B, Tq, Tk)} {kind} {state}: "
              f"{f32_err}")
        ms = cuda_ms(torch, lambda: FLASH(q, k, v, q_pos, k_pos,
                                          window=window), iters, flush)
        dev_ms, dev_src, dev_by = device_ms(torch, lambda: FLASH(
            q, k, v, q_pos, k_pos, window=window))
        plain_ms = cuda_ms(torch, lambda: ref.attention_ref(
            q, k, v, q_pos, k_pos, window=window, q_chunk=512), 3, flush)
        # the yardstick: one PyTorch call of the same function
        rel = q_pos[:, :, None].long() - k_pos[:, None, :].long()
        mask = ((k_pos >= 0)[:, None, :] & (rel >= 0) & (rel < window)
                )[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), 3, flush)
        del rel, mask
        bound_ms, bound_by, flops, nbytes, live = attn_bound(
            torch, q_pos, k_pos, window, Hq, Hkv, dh)
        row = dict(shape=[B, Tq, Tk], Hq=Hq, Hkv=Hkv, dh=dh, entry=kind,
                   cache=state, window=window, layout=layout,
                   max_abs_err=err, bf16_err_of_tol=tight_err,
                   f32_rel_err=f32_err, ms=ms, device_ms=dev_ms,
                   device_ms_from=dev_src, device_ms_by_kernel=dev_by,
                   plain_ms=plain_ms,
                   library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes, live_pairs=live)
        print("[kernel] flash_attention " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def gemma_serve_phase(torch, np, FLASH, get_config, Engine, Request,
                      checked):
    """Serve Gemma-3-4B at its published widths in paged mode; the
    attention kernel's counts are set to 0 just before the run and read
    just after."""
    from repro_torch.configs.base import GLOBAL_WINDOW
    cfg = get_config("gemma3-4b")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n),
                    max_new_tokens=TOKENS)
            for i, n in enumerate(GEMMA_PROMPTS)]
    engine = Engine(cfg, slots=SLOTS, max_len=GEMMA_MAX_LEN, seed=0,
                    cache_mode="paged", block_size=BLOCK,
                    policy="conservative", device=DEVICE)
    check(engine.cache_mode == "paged", engine.cache_mode)
    engine.load(engine.model.init(seed=0))
    engine.run_to_completion([Request(rid=99, prompt=np.arange(8),
                                      max_new_tokens=2)])   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FLASH.reset_counts()
    t0 = time.perf_counter()
    res = engine.run_to_completion(reqs)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches, by_shape = FLASH.launches, dict(FLASH.by_shape)
    by_layout = dict(FLASH.by_layout)

    check(not res.truncated and sorted(res) == list(range(len(reqs))),
          f"not every request completed: {sorted(res)}")
    for rid, toks in res.items():
        check(len(toks) == TOKENS, f"request {rid} got {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"request {rid} produced out-of-vocabulary tokens")
    check(engine.pool.used_blocks == 0, "the pool was not drained")
    check(launches > 0, "the serve never launched the attention kernel")
    check(set(by_shape) <= checked,
          f"the serve launched the attention kernel at (batch, Tq, Tk) "
          f"{sorted(set(by_shape) - checked)}, which phase 6 did not check")
    windows = cfg.layer_windows()
    n_global = sum(w == GLOBAL_WINDOW for w in windows)
    n_local = len(windows) - n_global
    ticks = {}
    for (b, tq, tk), n in by_shape.items():
        local = tk in (WINDOW, WINDOW + tq)
        check(n % (n_local if local else n_global) == 0,
              f"{n} launches at {(b, tq, tk)}")
        ticks.setdefault(tq, {})["local" if local else "global"] = \
            n // (n_local if local else n_global)
    for tq, t in ticks.items():
        check(t.get("local") == t.get("global") and t["local"] > 0,
              f"attention layers launched unevenly at Tq={tq}: {t}")
    check(launches == len(windows) * sum(t["local"] for t in ticks.values()),
          "not every attention layer launched the kernel in every tick")
    ttfts = sorted(m["ttft_s"] for m in res.metrics.values())
    p95 = ttfts[min(len(ttfts) - 1, int(0.95 * len(ttfts)))]
    gaps = sorted((m["done_s"] - m["arrival_s"] - m["ttft_s"])
                  / (m["tokens"] - 1) for m in res.metrics.values())
    tokens = sum(len(v) for v in res.values())
    print("[serve] " + json.dumps(dict(
        arch=cfg.name, cache_mode=engine.cache_mode, policy="conservative",
        slots=SLOTS, max_len=GEMMA_MAX_LEN, block_size=BLOCK,
        prompt_lengths=list(GEMMA_PROMPTS), new_tokens=TOKENS,
        completed=len(res), tokens=tokens, seconds=elapsed,
        tokens_per_s=tokens / elapsed, ttft_s=ttfts, p95_ttft_s=p95,
        s_per_token_after_first=gaps,
        pool_high_water_blocks=engine.pool.high_water,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)),
        flush=True)
    decode = sum(n for (_, tq, _), n in by_shape.items() if tq == 1)
    check(by_layout == {k: v for k, v in (("decode", decode),
                                          ("wgmma", launches - decode)) if v},
          f"the serve's attention layouts {by_layout} do not follow Tq")
    print("[kernels] " + json.dumps(dict(
        flash_attention=launches, by_layout=by_layout,
        ticks_by_width={str(tq): t["local"] for tq, t in ticks.items()},
        by_batch_tq_tk={f"{b}x{tq}x{tk}": n
                        for (b, tq, tk), n in sorted(by_shape.items())})),
          flush=True)
    profile_ticks(torch, np, engine, Request)
    return launches


def profile_ticks(torch, np, engine, Request):
    """Device busy time and time by kernel (torch.profiler) over one chunk
    tick and four decode ticks of the Gemma engine, for 4 fresh 40-token
    requests: where a tick's time goes, and how long the card waits for
    the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev_us = _dev_us

    rng = np.random.default_rng(5)
    for i in range(SLOTS):
        check(engine.admit(Request(
            rid=100 + i, prompt=rng.integers(0, engine.cfg.vocab_size,
                                             size=40), max_new_tokens=8)),
              "the profiled requests were not admitted")
    out = {}
    for name, n in (("chunk_tick", 1), ("decode_tick", 4)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in kern) / 1e6
        top = sorted(kern, key=dev_us, reverse=True)[:8]
        out[name] = dict(
            ticks=n, wall_s=wall, device_busy_s=busy if busy else
            "not measured", idle_share=1 - busy / wall if busy else
            "not measured",
            attention_s=sum(dev_us(e) for e in kern
                            if "flash_" in e.key) / 1e6,
            top=[[e.key[:70], dev_us(e) / 1e3, e.count] for e in top])
    while engine.sched.has_work():
        engine.step()
    print("[profile] " + json.dumps(out), flush=True)


def gemma_parity(torch, get_config, reduced, Model, Engine, Request):
    """The reduced Gemma config with f32 weights: card against CPU logits,
    and paged against dense greedy tokens on the card."""
    import numpy as np
    cfg = reduced(get_config("gemma3-4b"))
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
    lg_c, cache_c = cpu.prefill(p_cpu, prompt, max_len=24)
    lg_g, cache_g = gpu.prefill(p_gpu, prompt.to(DEVICE), max_len=24)
    errs = [rel_err(lg_g.cpu(), lg_c)]
    for step in range(4):                 # the window-8 ring wraps
        tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=g)
        pos = torch.full((2,), 16 + step, dtype=torch.int32)
        lg_c, cache_c = cpu.decode_step(p_cpu, tok, pos, cache_c)
        lg_g, cache_g = gpu.decode_step(p_gpu, tok.to(DEVICE),
                                        pos.to(DEVICE), cache_g)
        errs.append(rel_err(lg_g.cpu(), lg_c))
    print(f"[parity] reduced gemma3-4b, card vs CPU logits: max error "
          f"{max(errs):.3e} (tolerance {GEMMA_TOL})", flush=True)
    check(max(errs) < GEMMA_TOL, f"card and CPU disagree: {errs}")

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 3, 7)]
    out = {}
    for mode in ("paged", "dense"):
        eng = Engine(cfg, slots=3, max_len=32, block_size=8, cache_mode=mode,
                     device=DEVICE)
        eng.load(p_gpu)
        out[mode] = dict(eng.run_to_completion(
            [Request(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)]))
        # a decode dispatch enqueues its work without waiting for the card
        args = [torch.tensor(a, device=DEVICE) for a in
                ([[1], [1], [1]], [5, 9, 3], [1, 1, 0])]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.model.serve_step(eng.params, args[0], args[1].int(),
                                 args[2].int(), eng.cache)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print(f"[parity] reduced gemma3-4b on the card, paged vs dense greedy "
          f"tokens equal: {out['paged'] == out['dense']}", flush=True)
    check(out["paged"] == out["dense"] and len(out["paged"]) == 4,
          f"paged and dense serving disagree: {out}")


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
    from repro_torch.kernels.ops import FLASH_ATTENTION as FLASH
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
    with ThreadPoolExecutor(2) as pool:      # one nvcc for each source
        for fut in [pool.submit(k.load) for k in (KERNEL, FLASH)]:
            fut.result()
    print(f"[build] mlstm_chunk and flash_attention built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, kern in (("mlstm_chunk", KERNEL), ("flash_attention", FLASH)):
        for line in kern.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    rows = kernel_phase(torch, F, KERNEL, ref)
    launches, by_shape, engine = serve_phase(torch, np, KERNEL, get_config,
                                             Engine, Request)
    checked = {(r["shape"][0], r["shape"][2]) for r in rows}
    check(set(by_shape) <= checked,
          f"serving launched the kernel at (batch, length) "
          f"{sorted(set(by_shape) - checked)}, which phase 2 did not check")
    prefill_breakdown(torch, engine, ssm)
    del engine
    reduced_parity(torch, get_config, reduced, Model)
    torch.cuda.empty_cache()

    attn_rows = attention_phase(torch, F, FLASH, ref)
    attn_launches = gemma_serve_phase(
        torch, np, FLASH, get_config, Engine, Request,
        {tuple(r["shape"]) for r in attn_rows})
    torch.cuda.empty_cache()
    gemma_parity(torch, get_config, reduced, Model, Engine, Request)

    main_row = rows[0]       # the prefill shape the engine sends
    # the heaviest attention call of the serve: the first chunk tick over
    # a global entry
    attn_main = next(r for r in attn_rows
                     if r["entry"] == "global" and r["cache"] == "empty")
    print(json.dumps({"kernels": [{
        "name": "mlstm_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk.py:103",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:101",
        "launches": attn_launches,
        "max_abs_err": max(r["max_abs_err"] for r in attn_rows),
        "ms": attn_main["ms"], "plain_ms": attn_main["plain_ms"],
        "bound_ms": attn_main["bound_ms"],
        "bound_by": attn_main["bound_by"],
        "library_ms": attn_main["library_ms"]}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
