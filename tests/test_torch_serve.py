"""The port's serving engine (legacy mode) against the reference engine,
and its guards.

Greedy tokens are compared exactly: both engines get the same f32 weights,
so the logits agree to f32 rounding (test_torch_model.py) and an argmax
could only flip on a tie within that rounding.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.launch.mesh import mesh_for_devices
from repro.models.model import Model as JaxModel
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import Scheduler as JaxScheduler
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve import Engine, Request
from repro_torch.serve.scheduler import Scheduler

CFG = reduced(get_config("xlstm-350m"))
LENGTHS = (3, 5, 8, 13)     # 8 and 13 run the chunked prefill (chunk 8)


def _prompts(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n) for n in LENGTHS]


def _port_engine(params, slots=4, **kw):
    eng = Engine(CFG, slots=slots, max_len=32, device="cpu", **kw)
    eng.load(params)
    return eng


def test_greedy_tokens_match_reference_engine():
    jcfg = jax_reduced(jax_get_config("xlstm-350m"))
    mesh = mesh_for_devices(1)
    params = JaxModel(jcfg, mesh).init(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    jeng = JaxEngine(jcfg, mesh, slots=4, max_len=32)
    assert jeng.cache_mode == "legacy"
    jeng.load(params)
    want = jeng.run_to_completion(
        [JaxRequest(rid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(_prompts())])

    eng = _port_engine(params_from_jax(jax.tree.map(np.asarray, params),
                                       device="cpu"))
    got = eng.run_to_completion([Request(rid=i, prompt=p, max_new_tokens=5)
                                 for i, p in enumerate(_prompts())])
    assert not got.truncated and not want.truncated
    assert dict(got) == dict(want)
    assert all(got.metrics[r]["ttft_s"] is not None for r in got)


def test_reused_slot_matches_solo_and_sampling_is_seeded():
    params = Model(CFG, device="cpu").init(seed=3)
    prompts = _prompts(seed=4)[:2]
    shared = _port_engine(params, slots=1).run_to_completion(
        [Request(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)])
    solo = _port_engine(params, slots=1).run_to_completion(
        [Request(rid=1, prompt=prompts[1], max_new_tokens=4)])
    assert shared[1] == solo[1]

    def sampled(seed):
        eng = _port_engine(params, seed=seed)
        return dict(eng.run_to_completion(
            [Request(rid=i, prompt=p, max_new_tokens=6, temperature=1.0)
             for i, p in enumerate(_prompts())]))
    assert sampled(5) == sampled(5)
    assert sampled(5) != sampled(6)


def test_guards():
    with pytest.raises(ValueError, match="legacy"):
        Engine(CFG, slots=2, max_len=16, cache_mode="paged", device="cpu")
    eng = Engine(CFG, slots=2, max_len=16, device="cpu")
    assert eng.cache_mode == "legacy"
    with pytest.raises(RuntimeError, match="load"):
        eng.run_to_completion([Request(rid=0, prompt=np.arange(3))])
    eng.load(Model(CFG, device="cpu").init(seed=0))
    for prompt in (np.arange(0), np.arange(16)):    # empty; no room to decode
        with pytest.raises(ValueError, match="prompt"):
            eng.run_to_completion([Request(rid=0, prompt=prompt)])
    if not torch.cuda.is_available():
        # entry points run on the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(CFG)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(CFG, slots=2, max_len=16)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax({"dec_xlstm": ()})


@pytest.mark.parametrize("admissions", [
    {0: [(0, 6, 3)], 1: [(1, 2, 2)], 3: [(2, 9, 1)]},     # staggered
    {0: [(0, 4, 5), (1, 3, 2), (2, 7, 4)], 6: [(1, 2, 3)]},  # slot reuse
], ids=["staggered", "reuse"])
def test_scheduler_plans_match_reference(admissions):
    """The same admissions give the same decode plans, tick by tick.  As in
    the legacy engine, each admission is prefilled at once (``fed`` = the
    prompt, token 0 sampled), so every tick the reference plans is a
    decode tick, and its slots release when their cap is dispatched."""
    scheds = [JaxScheduler(slots=3, chunk=4), Scheduler(slots=3, chunk=4)]
    for tick in range(12):
        for slot, n, cap in admissions.get(tick, []):
            for s in scheds:
                st = s.assign(slot, rid=slot, prompt=np.arange(n), cap=cap,
                              temperature=0.0, eos_id=None)
                st.fed, st.sampled = n, 1
        want, got = (s.plan() for s in scheds)
        if want is None:
            assert got is None
            continue
        assert want.kind == "decode" and want.width == 1
        assert got.samples == want.samples
        np.testing.assert_array_equal(got.starts, want.starts)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        np.testing.assert_array_equal(want.use_next, got.lengths > 0)
        np.testing.assert_array_equal(want.tokens, 0)
        for s in scheds:
            for i, st in s.active():
                if st.sampled >= st.cap:
                    s.release(i)


@pytest.mark.parametrize("arch,mode", [("xlstm-350m", "legacy"),
                                       ("gemma3-4b", "paged")])
def test_launcher_serves_on_cpu(arch, mode):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch, "--reduced", "--device", "cpu", "--slots", "2",
         "--requests", "3", "--new-tokens", "3", "--max-len", "80",
         "--rate", "200"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"mode={mode} device=cpu completed 3/3 requests, 9 tokens" \
        in out.stdout
    assert "kernel launches: flash_attention 0, mlstm_chunk 0" in out.stdout
