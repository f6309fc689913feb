"""The port's mLSTM and sLSTM blocks against the reference's, with the
reference's weights carried over by ``params_from_jax``.

Tolerances: with f32 weights and inputs, 1e-4 of the output's scale (f32
sums in another order, as in test_torch_kernels.py).  With the default
bf16 weights, 3e-2: each side rounds the projections, the normalised
hidden state and the residual sum to bf16 (2^-8 = 3.9e-3 relative each)
at different points, so a few bf16 steps of the output's scale apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import ssm as jssm
from repro.models.model import Model as JaxModel
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm

CFG = jax_reduced(jax_get_config("xlstm-350m"))
H, DH = CFG.num_heads, CFG.head_dim


def _err(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


def _blocks(dtype):
    """(reference params of layer 0 and 1, the port's) in ``dtype``."""
    params = JaxModel(CFG).init(jax.random.PRNGKey(0))
    if dtype == "f32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tree = jax.tree.map(np.asarray, params)
    port = params_from_jax(tree, device="cpu")
    mjax = jax.tree.map(lambda a: a[0], params["dec_xlstm"][0])
    sjax = jax.tree.map(lambda a: a[0], params["dec_xlstm"][1])
    return (mjax, sjax), port["layers"][:2]


def _x(S, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, CFG.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 3e-2)])
def test_mlstm_and_slstm_forward_match_reference(dtype, tol):
    (mjax, sjax), (mport, sport) = _blocks(dtype)
    jx, tx = _x(24, dtype)
    y_j, st_j = jssm.mlstm_forward(mjax, jx, None, heads=H, dh=DH, chunk=8)
    y_p, st_p = ssm.mlstm_forward(mport, tx, None, heads=H, dh=DH, chunk=8)
    assert _err(y_p, y_j.astype(jnp.float32)) < tol
    for a, b in zip(st_p, st_j):
        assert _err(a, b) < tol
    y_j, st_j = jssm.slstm_forward(sjax, jx, None, heads=H, dh=DH)
    y_p, st_p = ssm.slstm_forward(sport, tx, None, heads=H, dh=DH)
    assert _err(y_p, y_j.astype(jnp.float32)) < tol
    for a, b in zip(st_p, st_j):
        assert _err(a, b) < tol


def test_two_halves_equal_the_whole():
    """State continuity: running the second half from the first half's
    state gives the whole sequence's outputs and final state."""
    _, (mport, sport) = _blocks("f32")
    _, tx = _x(32, "f32", seed=1)
    for fwd, kw in ((ssm.mlstm_forward, {"chunk": 8}),
                    (ssm.slstm_forward, {})):
        p = mport if fwd is ssm.mlstm_forward else sport
        y, st = fwd(p, tx, None, heads=H, dh=DH, **kw)
        y1, st1 = fwd(p, tx[:, :16], None, heads=H, dh=DH, **kw)
        y2, st2 = fwd(p, tx[:, 16:], st1, heads=H, dh=DH, **kw)
        assert _err(torch.cat([y1, y2], dim=1), y) < 1e-5
        for a, b in zip(st2, st):
            assert _err(a, b) < 1e-5


def test_chunked_mlstm_matches_sequential():
    _, (mport, _) = _blocks("f32")
    _, tx = _x(16, "f32", seed=2)
    y, st = ssm.mlstm_forward(mport, tx, None, heads=H, dh=DH, chunk=8)
    y_s, st_s = ssm.mlstm_sequential(mport, tx, None, heads=H, dh=DH)
    assert _err(y, y_s) < 1e-4
    for a, b in zip(st, st_s):
        assert _err(a, b) < 1e-4
