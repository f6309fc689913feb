"""Slice 2 of the port, Gemma-3 (reduced: 2 x (1 local + 1 global) layers,
window 8, GQA 4/4, dh 16) against the reference on the CPU:

* the dense ``Model``: prefill and decode logits and caches against the JAX
  ``Model`` through ``params_from_jax``, over dense rings and, through
  ``serve_step``, over a paged pool;
* ``BlockPool`` and the scheduler's conservative and mixed ticks, as in
  ``tests/test_serve.py``, and tick for tick against the reference
  scheduler;
* the engine: paged bitwise equal to dense at temperature 0 (the mixed
  policy and the legacy mode complete the same requests), staggered
  admission equal to solo, EOS, seeded sampling, truncation, guards, and
  greedy tokens equal to the JAX ``Engine``'s in paged mode.

Tolerances, relative to max(1, max |reference|): with f32 weights, 1e-3 on
logits and 1e-2 on cached keys and values.  The KV cache is bf16 on both
sides (as in the reference, whatever the weights), and an f32 difference of
one rounding step in RoPE can round a cached key to the neighbouring bf16
value (2^-8 relative) and move later logits by a few 1e-4.  With the
default bf16 weights, 5e-2: each layer rounds its hidden state to bf16 at
places that differ between XLA and PyTorch.  Greedy tokens are compared
exactly: an argmax could only flip on a near-tie within that rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.launch.mesh import mesh_for_devices
from repro.models import cache as jax_cache
from repro.models.model import Model as JaxModel
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import Scheduler as JaxScheduler
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models.cache import PageSpec
from repro_torch.models.model import Model
from repro_torch.serve import Engine, Request
from repro_torch.serve.pool import BlockPool, PoolExhausted
from repro_torch.serve.scheduler import Scheduler

CFG = reduced(get_config("gemma3-4b"))
TOL = {"f32": 1e-3, "bf16": 5e-2}
CACHE_TOL = {"f32": 1e-2, "bf16": 5e-2}


def _err(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


@pytest.fixture(scope="module")
def ref_params():
    jcfg = jax_reduced(jax_get_config("gemma3-4b"))
    return jcfg, JaxModel(jcfg).init(jax.random.PRNGKey(0))


def _weights(ref_params, dtype):
    jcfg, params = ref_params
    if dtype == "f32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params),
                                         device="cpu")


def _assert_caches_match(cache_p, cache_j, tol):
    assert sorted(cache_p) == sorted(cache_j)
    for name, ent in cache_j.items():
        assert sorted(cache_p[name]) == sorted(ent), name
        for key, val in ent.items():
            got = cache_p[name][key]
            assert tuple(got.shape) == val.shape, (name, key)
            if key in ("pos", "btab"):
                np.testing.assert_array_equal(got.numpy(), np.asarray(val))
            else:
                assert _err(got, val) < tol, (name, key)


# --------------------------------------------------------------- the model


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_then_decode_matches_reference(ref_params, dtype):
    jcfg, params, tparams = _weights(ref_params, dtype)
    jmodel, model = JaxModel(jcfg), Model(CFG, device="cpu")
    assert [g.name for g in model.groups] == ["gsuper"]
    assert len(tparams["layers"]) == jcfg.num_layers
    assert "unemb" not in tparams                   # tied embeddings
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, CFG.vocab_size, size=(2, 16)).astype(np.int32)
    lg_j, cache_j = jmodel.prefill(params, jnp.asarray(prompt), max_len=24)
    lg_p, cache_p = model.prefill(tparams, torch.from_numpy(prompt).long(),
                                  max_len=24)
    assert lg_p.shape == (2, 1, CFG.vocab_size)
    assert _err(lg_p, lg_j) < TOL[dtype]
    for step in range(4):           # 16 + 4 > window 8: the local ring wraps
        tok = rng.integers(0, CFG.vocab_size, size=(2, 1)).astype(np.int32)
        pos = np.full((2,), 16 + step, np.int32)
        lg_j, cache_j = jmodel.decode_step(params, jnp.asarray(tok),
                                           jnp.asarray(pos), cache_j)
        lg_p, cache_p = model.decode_step(tparams,
                                          torch.from_numpy(tok).long(),
                                          torch.from_numpy(pos), cache_p)
        assert _err(lg_p, lg_j) < TOL[dtype], step
    _assert_caches_match(cache_p, cache_j, CACHE_TOL[dtype])


def test_serve_step_over_a_paged_pool_matches_reference(ref_params):
    """A ragged chunk tick (two rows, one padded, one idle) then a decode
    tick, through the block table, against the reference's serve_step."""
    jcfg, params, tparams = _weights(ref_params, "f32")
    jmodel, model = JaxModel(jcfg), Model(CFG, device="cpu")
    spec = PageSpec(block_size=4, num_blocks=12)
    cache_j = jmodel.init_cache(3, 16, paged=jax_cache.PageSpec(4, 12))
    cache_p = model.init_cache(3, 16, paged=spec)
    btab = np.full((3, 4), -1, np.int32)
    btab[0, :3] = (7, 2, 9)
    btab[1, :2] = (0, 11)
    for name in cache_j:
        if "btab" in cache_j[name]:
            cache_j[name]["btab"] = jnp.asarray(btab)
            cache_p[name]["btab"].copy_(torch.from_numpy(btab))
    rng = np.random.default_rng(1)
    ticks = [(rng.integers(0, CFG.vocab_size, size=(3, 8)), (0, 0, 0),
              (8, 5, 0)),
             (rng.integers(0, CFG.vocab_size, size=(3, 1)), (8, 5, 0),
              (1, 1, 0))]
    for tokens, starts, lengths in ticks:
        args = [np.asarray(a, np.int32) for a in (tokens, starts, lengths)]
        lg_j, cache_j = jmodel.serve_step(params, *map(jnp.asarray, args),
                                          cache_j)
        lg_p, cache_p = model.serve_step(
            tparams, torch.from_numpy(args[0]).long(),
            *map(torch.from_numpy, args[1:]), cache_p)
        assert _err(lg_p[:2], np.asarray(lg_j)[:2]) < TOL["f32"]
    _assert_caches_match(cache_p, cache_j, CACHE_TOL["f32"])


def test_reset_cache_slots_matches_reference(ref_params):
    jcfg, params, tparams = _weights(ref_params, "f32")
    jmodel, model = JaxModel(jcfg), Model(CFG, device="cpu")
    cache_j = jmodel.init_cache(2, 16, paged=jax_cache.PageSpec(4, 8))
    cache_p = model.init_cache(2, 16, paged=PageSpec(4, 8))
    btab = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    for name in cache_j:
        if "btab" in cache_j[name]:
            cache_j[name]["btab"] = jnp.asarray(btab)
            cache_p[name]["btab"].copy_(torch.from_numpy(btab))
    tokens = np.arange(12, dtype=np.int32).reshape(2, 6)
    args = (tokens, np.zeros(2, np.int32), np.full(2, 6, np.int32))
    _, cache_j = jmodel.serve_step(params, *map(jnp.asarray, args), cache_j)
    _, cache_p = model.serve_step(tparams, torch.from_numpy(tokens).long(),
                                  *map(torch.from_numpy, args[1:]), cache_p)
    cache_j = jmodel.reset_cache_slots(cache_j, jnp.asarray([True, False]))
    cache_p = model.reset_cache_slots(cache_p, torch.tensor([True, False]))
    _assert_caches_match(cache_p, cache_j, CACHE_TOL["f32"])


# ----------------------------------------------------- pool and scheduler


def test_block_pool_accounting():
    pool = BlockPool(num_blocks=8, block_size=4, slots=3, max_len=16)
    assert pool.max_blocks_per_slot == 4
    assert pool.blocks_for(0) == 0 and pool.blocks_for(1) == 1
    assert pool.blocks_for(4) == 1 and pool.blocks_for(5) == 2
    pool.reserve(0, 9)
    assert pool.committed == 3 and pool.used_blocks == 0
    with pytest.raises(ValueError):
        pool.reserve(0, 4)
    pool.ensure(0, 5)
    assert pool.used_blocks == 2 and pool.high_water == 2 and pool.dirty
    assert (pool.table[0, :2] >= 0).all() and pool.table[0, 2] == -1
    with pytest.raises(PoolExhausted):
        pool.ensure(0, 13)
    pool.reserve(1, 16)
    assert not pool.can_reserve(16) and pool.can_reserve(4)
    with pytest.raises(PoolExhausted):
        pool.reserve(2, 16)
    pool.release(0)
    assert pool.committed == 4 and pool.used_blocks == 0
    assert (pool.table[0] == -1).all() and pool.high_water == 2
    with pytest.raises(ValueError):
        BlockPool(num_blocks=0, block_size=4, slots=1, max_len=16)


def test_scheduler_conservative_ticks():
    sched = Scheduler(slots=2, chunk=4)
    st = sched.assign(0, rid=7, prompt=np.arange(6), cap=2,
                      temperature=0.0, eos_id=None)
    p1 = sched.plan()
    assert p1.kind == "chunk" and p1.width == 4
    assert list(p1.lengths) == [4, 0] and list(p1.starts) == [0, 0]
    assert not p1.samples and not p1.use_next.any() and st.fed == 4
    p2 = sched.plan()
    assert list(p2.lengths) == [2, 0] and p2.starts[0] == 4
    assert p2.samples == [(0, st.epoch, 0)] and st.sampled == 1
    p3 = sched.plan()
    assert p3.kind == "decode" and p3.width == 1
    assert p3.use_next[0] and p3.samples == [(0, st.epoch, 1)]
    assert sched.plan() is None and not sched.has_work()
    with pytest.raises(ValueError):
        Scheduler(slots=1, chunk=4, policy="nope")


def test_scheduler_mixed_packs_decode_into_chunks():
    sched = Scheduler(slots=2, chunk=4, policy="mixed")
    s0 = sched.assign(0, rid=0, prompt=np.arange(2), cap=3,
                      temperature=0.0, eos_id=None)
    sched.plan()
    assert s0.decode_ready
    s1 = sched.assign(1, rid=1, prompt=np.arange(6), cap=1,
                      temperature=0.0, eos_id=None)
    p = sched.plan()
    assert p.kind == "chunk"
    assert list(p.lengths) == [1, 4] and list(p.use_next) == [True, False]
    assert (0, s0.epoch, 1) in p.samples and s1.prefilling


@pytest.mark.parametrize("policy", ["conservative", "mixed"])
def test_scheduler_plans_match_reference_tick_for_tick(policy):
    admissions = {0: [(0, 6, 3)], 1: [(1, 9, 2)], 3: [(2, 2, 4)],
                  9: [(0, 5, 2)]}
    scheds = [JaxScheduler(3, 4, policy), Scheduler(3, 4, policy)]
    for tick in range(16):
        for slot, n, cap in admissions.get(tick, []):
            for s in scheds:
                s.assign(slot, rid=10 * tick + slot, prompt=np.arange(n),
                         cap=cap, temperature=0.0, eos_id=None)
        want, got = (s.plan() for s in scheds)
        if want is None:
            assert got is None
            continue
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
        for s in scheds:
            for i, st in s.active():
                if st.sampled >= st.cap:
                    s.release(i)


# ------------------------------------------------------------- the engine


@pytest.fixture(scope="module")
def params():
    return Model(CFG, device="cpu").init(seed=0)


def _engine(params, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 32)
    kw.setdefault("block_size", 8)
    eng = Engine(CFG, device="cpu", **kw)
    eng.load(params)
    return eng


def _reqs(lens=(5, 9, 3, 7), new=4, cls=Request, **kw):
    rng = np.random.default_rng(1)
    return [cls(rid=i, prompt=rng.integers(0, CFG.vocab_size, size=n),
                max_new_tokens=new, **kw) for i, n in enumerate(lens)]


def test_paged_matches_dense_bitwise_and_memory(params):
    paged = _engine(params, cache_mode="paged")
    dense = _engine(params, cache_mode="dense")
    assert Engine(CFG, slots=1, max_len=8, device="cpu").cache_mode == "paged"
    res_p = paged.run_to_completion(_reqs())
    res_d = dense.run_to_completion(_reqs())
    assert not res_p.truncated and not res_d.truncated
    assert sorted(res_p) == sorted(res_d) == [0, 1, 2, 3]
    for rid in res_p:
        assert res_p[rid] == res_d[rid] and len(res_p[rid]) == 4
        m = res_p.metrics[rid]
        assert m["tokens"] == 4 and m["done_s"] >= m["ttft_s"] >= 0.0
    pool = paged.pool
    assert pool.used_blocks == 0
    assert 0 < pool.high_water * pool.block_size < paged.slots * paged.max_len
    assert dense.pool is None
    for kw in (dict(policy="mixed"), dict(cache_mode="legacy")):
        res = _engine(params, **kw).run_to_completion(_reqs())
        assert sorted(res) == [0, 1, 2, 3], kw
        assert all(len(t) == 4 for t in res.values()), kw


def test_staggered_admission_matches_solo_greedy(params):
    solo_engine = _engine(params, slots=1)
    solo = {r.rid: solo_engine.run_to_completion([r])[r.rid]
            for r in _reqs(lens=(5, 9, 3))}
    eng = _engine(params)
    reqs = _reqs(lens=(5, 9, 3))
    assert eng.admit(reqs[0])
    for _ in range(2):
        eng.step()
    assert eng.admit(reqs[1])
    eng.step()
    assert eng.admit(reqs[2])
    while eng.sched.has_work():
        eng.step()
    for r in reqs:
        assert r.out_tokens == solo[r.rid], r.rid


def test_eos_stops_generation(params):
    base = _engine(params, slots=1).run_to_completion(
        _reqs(lens=(6,), new=6))[0]
    k = base.index(base[len(base) // 2])
    res = _engine(params).run_to_completion(
        _reqs(lens=(6,), new=6, eos_id=base[k]))
    assert res[0] == base[:k + 1] and res.metrics[0]["tokens"] == k + 1


def test_sampling_is_seeded(params):
    def run(seed):
        res = _engine(params, seed=seed).run_to_completion(
            _reqs(lens=(5, 9), new=6, temperature=0.8))
        return [res[0], res[1]]
    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c and all(len(t) == 6 for t in a)


def test_truncation_guards_and_pool_limits(params):
    eng = _engine(params)
    res = eng.run_to_completion(_reqs(lens=(5, 9), new=6), max_steps=2)
    assert res.truncated and set(res.unfinished) == {0, 1} and not res
    while eng.sched.has_work():
        eng.step()
    assert eng.pool.used_blocks == 0
    res = eng.run_to_completion(_reqs(lens=(4,), new=0))
    assert res[0] == [] and res.metrics[0]["tokens"] == 0
    with pytest.raises(ValueError):
        eng.run_to_completion(_reqs(lens=(32,)))
    small = _engine(params, slots=1, num_blocks=1)
    with pytest.raises(ValueError, match="blocks"):
        small.run_to_completion(_reqs(lens=(9,)))
    cold = Engine(CFG, slots=1, max_len=32, device="cpu")
    for call in (lambda: cold.admit(Request(rid=0, prompt=np.arange(3))),
                 cold.step, lambda: cold.run_to_completion([])):
        with pytest.raises(RuntimeError, match="load"):
            call()
    with pytest.raises(ValueError, match="cache_mode"):
        Engine(CFG, slots=1, max_len=8, cache_mode="nope", device="cpu")


def test_greedy_tokens_match_reference_engine(ref_params):
    # a slot for each request: under CPU contention the reference engine
    # gives a request admitted into a reused slot one of two outputs from
    # run to run (with a slot each, one output).  The port's slot reuse is
    # held to solo output by test_staggered_admission_matches_solo_greedy.
    jcfg, jparams, tparams = _weights(ref_params, "f32")
    jeng = JaxEngine(jcfg, mesh_for_devices(1), slots=4, max_len=32,
                     block_size=8)
    assert jeng.cache_mode == "paged"
    jeng.load(jparams)
    want = jeng.run_to_completion(_reqs(cls=JaxRequest))
    got = _engine(tparams, slots=4).run_to_completion(_reqs())
    assert not got.truncated and not want.truncated
    assert dict(got) == dict(want)
