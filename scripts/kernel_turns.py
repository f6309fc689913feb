#!/usr/bin/env python3
"""Time the port's two kernel wrappers from two source trees in turns on one
card: A, B, B, A, each turn a process of its own.

    python3 scripts/kernel_turns.py ROOT_A ROOT_B

Each root is a checkout of the repository (it holds ``src/repro_torch``),
for example the parent commit unpacked with ``git archive`` (A) and this
one (B).  Each turn builds that root's kernels and, at the shapes that
``chip_smoke.py`` times, prints one ``[turn]`` JSON line per shape with:

- ``ms``: CUDA events around one call after an L2 flush, as
  ``chip_smoke.cuda_ms`` (the wrapper's host work shows where the card
  waits for it);
- ``device_ms``: the kernels' device time of one call, as
  ``chip_smoke.device_ms``;
- ``host_us``: the host clock per call over back-to-back calls that the
  card keeps up with, the wrapper's own Python and launch cost.

The last line is a JSON summary: for each shape and root, the mean of its
two turns.  Helpers and shapes come from this checkout's ``chip_smoke.py``;
the kernels and wrappers are each root's own.  Needs one CUDA card.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

MLSTM = [(1, 4, 4096, 256, "zero"), (4, 4, 1, 256, "random"),
         (1, 4, 1, 256, "random")]
ATTN = [("local", "empty"), ("local", "wrapped"), ("global", "empty"),
        ("global", "wrapped"), ("local", "decode"), ("global", "decode")]


def host_us(torch, fn, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def worker(root: str) -> None:
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(1, REPO)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import FLASH_ATTENTION, MLSTM_CHUNK
    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: needs a CUDA device")
    MLSTM_CHUNK.load()
    FLASH_ATTENTION.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_

    for B, H, S, dh, state in MLSTM:
        q, k, v = (torch.randn((B, H, S, dh), generator=gen, device=dev)
                   for _ in range(3))
        li = 0.5 * torch.randn((B, H, S), generator=gen, device=dev)
        lf = F.logsigmoid(torch.randn((B, H, S), generator=gen, device=dev)
                          + 2.0)
        st = (torch.randn((B, H, dh, dh), generator=gen, device=dev),
              torch.randn((B, H, dh), generator=gen, device=dev),
              torch.randn((B, H), generator=gen, device=dev))
        if state == "zero":
            st = (st[0].zero_(), st[1].zero_(), st[2].fill_(float("-inf")))

        def fn():
            return MLSTM_CHUNK(q, k, v, li, lf, st, chunk=256)
        row = dict(root=root, kernel="mlstm_chunk", shape=[B, H, S, dh],
                   ms=cs.cuda_ms(torch, fn, 20, flush),
                   device_ms=cs.device_ms(torch, fn)[0],
                   host_us=host_us(torch, fn, 50 if S > 1 else 500))
        print("[turn] " + json.dumps(row), flush=True)

    Hq, Hkv, dh = cs.GEMMA_HEADS
    for kind, state in ATTN:
        window = cs.WINDOW if kind == "local" else ref.GLOBAL_WINDOW
        q_pos, k_pos = cs.attn_positions(torch, kind, state, dev)
        (B, Tq), Tk = q_pos.shape, k_pos.shape[1]
        q = torch.randn((B, Tq, Hq, dh), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k, v = (torch.randn((B, Tk, Hkv, dh), generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2))

        def fn():
            return FLASH_ATTENTION(q, k, v, q_pos, k_pos, window=window)
        row = dict(root=root, kernel="flash_attention", shape=[B, Tq, Tk],
                   entry=kind, cache=state,
                   ms=cs.cuda_ms(torch, fn, 10, flush),
                   device_ms=cs.device_ms(torch, fn)[0],
                   host_us=host_us(torch, fn, 50 if Tq > 1 else 500))
        print("[turn] " + json.dumps(row), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(r) for r in sys.argv[1:])
    rows = []
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, __file__, "--worker", root],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout[-2000:] + out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            if line.startswith("[turn] "):
                print(line, flush=True)
                rows.append(json.loads(line[7:]))
    summary = {}
    for r in rows:
        key = " ".join([r["kernel"], "x".join(map(str, r["shape"])),
                        r.get("entry", ""), r.get("cache", "")]).strip()
        side = "A" if r["root"] == a else "B"
        d = summary.setdefault(key, {}).setdefault(side, {})
        for m in ("ms", "device_ms", "host_us"):
            d.setdefault(m, []).append(r[m])
    for key, sides in summary.items():
        for side, d in sides.items():
            sides[side] = {m: sum(v) / len(v) for m, v in d.items()}
    print(json.dumps({"A": a, "B": b, "mean_of_two_turns": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
