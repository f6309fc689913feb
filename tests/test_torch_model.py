"""The port's xLSTM ``Model`` against the reference ``Model``: prefill
(two chunks of the reduced config's prefill_chunk = 8) then decode steps,
same weights (``params_from_jax``), same tokens.

Tolerances on logits and states: 1e-4 of the scale with f32 weights (f32
sums in another order through 4 blocks); 5e-2 with the default bf16
weights, where each block rounds its hidden state to bf16 (2^-8 relative)
at places that differ between XLA and PyTorch, and four blocks compound
it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models.model import Model as JaxModel
from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model


def _err(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 5e-2)])
def test_prefill_then_decode_matches_reference(dtype, tol):
    jcfg = jax_reduced(jax_get_config("xlstm-350m"))
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    if dtype == "f32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = Model(reduced(get_config("xlstm-350m")), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    assert len(tparams["layers"]) == jcfg.num_layers

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    lg_j, cache_j = jmodel.prefill(params, jnp.asarray(prompt))
    lg_p, cache_p = model.prefill(tparams, torch.from_numpy(prompt).long())
    assert lg_p.shape == (2, 1, jcfg.vocab_size)
    assert _err(lg_p, lg_j) < tol
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
        pos = np.full((2,), 16 + step, np.int32)
        lg_j, cache_j = jmodel.decode_step(params, jnp.asarray(tok),
                                           jnp.asarray(pos), cache_j)
        lg_p, cache_p = model.decode_step(tparams,
                                          torch.from_numpy(tok).long(),
                                          torch.from_numpy(pos), cache_p)
        assert _err(lg_p, lg_j) < tol, step
    assert sorted(cache_p) == sorted(cache_j)
    for name, ent in cache_j.items():
        assert sorted(cache_p[name]) == sorted(ent)
        for key, val in ent.items():
            assert tuple(cache_p[name][key].shape) == val.shape
            assert _err(cache_p[name][key], val) < tol, (name, key)


def test_reset_cache_slots_matches_reference():
    jcfg = jax_reduced(jax_get_config("xlstm-350m"))
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1))
    prompt = np.arange(16, dtype=np.int32).reshape(2, 8)
    _, cache_j = jmodel.prefill(params, jnp.asarray(prompt))
    cache_j = jmodel.reset_cache_slots(cache_j, jnp.asarray([True, False]))
    model = Model(reduced(get_config("xlstm-350m")), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    _, cache_p = model.prefill(tparams, torch.from_numpy(prompt).long())
    cache_p = model.reset_cache_slots(cache_p, torch.tensor([True, False]))
    for name, ent in cache_j.items():
        for key, val in ent.items():
            got = cache_p[name][key].numpy()
            np.testing.assert_array_equal(got[:, 0], np.asarray(val[:, 0]))
            assert _err(got[:, 1], np.asarray(val[:, 1])) < 5e-2


def test_other_families_are_not_ported_yet():
    cfg = reduced(get_config("xlstm-350m"), xlstm_pattern=(), family="hybrid")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["xlstm-350m", "gemma3-4b"])
@pytest.mark.parametrize("cut", ["full", "reduced"])
def test_config_fields_equal_the_reference(cut, arch):
    """Every field the port's config keeps has the reference's value, at
    the published widths and after ``reduced``, and so do the per-layer
    windows and RoPE thetas."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if cut == "reduced":
        cfg, jcfg = reduced(cfg), jax_reduced(jcfg)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (cfg.q_dim, cfg.kv_dim) == (jcfg.q_dim, jcfg.kv_dim)
    assert cfg.layer_windows() == jcfg.layer_windows()
    assert cfg.layer_thetas() == jcfg.layer_thetas()
