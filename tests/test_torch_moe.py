"""The port's MoE ops against ray_tpu's, on the CPU.

The same seeded numpy inputs go through ``ray_tpu.ops.moe`` and
``ray_tpu_torch.ops.moe``. Tolerances:

- dispatch: exactly equal (0/1 entries, queue positions are integers);
- combine: within 1.2e-7 absolute. The gates are softmax outputs, and
  XLA's and PyTorch's float32 ``exp`` differ by an ulp (6e-8 near 1), so
  the renormalized gates can too; the routing itself is the same;
- aux loss: within 1e-6 (float32 sums in another order);
- ``moe_ffn`` in float32: within 1e-5 (float32 products in another
  summation order), values and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import moe as jmoe
from ray_tpu_torch.ops import moe as tmoe

COMBINE_ATOL = 1.2e-7
# the JAX side jitted: one compile instead of one per eager op
j_router_topk = jax.jit(jmoe.router_topk, static_argnames=("top_k",
                                                            "capacity"))
j_moe_ffn = jax.jit(jmoe.moe_ffn, static_argnames=("top_k",
                                                   "capacity_factor"))


def _logits(t, e, seed, ties=False):
    lg = np.random.default_rng(seed).standard_normal((t, e)) \
        .astype(np.float32)
    if ties:
        lg[1] = 0.25                  # every expert tied
        lg[2, :3] = lg[2, 3]          # four tied at the top or not
        lg[3, ::2] = 1.5              # ties between non-neighbours
    return lg


@pytest.mark.parametrize("t,e,k,capacity,drops", [
    (64, 8, 2, 16, True),             # capacity drops tokens
    (64, 8, 2, 64, False),            # room for every assignment
    (37, 4, 1, 5, True),              # top-1, ragged token count
    (50, 6, 3, 60, False),            # top-3
    (40, 8, 2, 10, True),             # tied gates, with drops
])
def test_router_topk_matches_jax(t, e, k, capacity, drops):
    lg = _logits(t, e, seed=t + e, ties=(t == 40))
    jd, jc, ja = j_router_topk(jnp.asarray(lg), top_k=k, capacity=capacity)
    td, tc, ta = tmoe.router_topk(torch.from_numpy(lg), top_k=k,
                                  capacity=capacity)
    assert td.shape == tc.shape == (t, e, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=COMBINE_ATOL)
    assert abs(float(ta) - float(ja)) <= 1e-6
    kept = float(td.sum())
    assert (kept < t * k) if drops else (kept == t * k)
    # each expert's queue is filled from position 0 without gaps
    filled = td.sum(0)                                   # [E, C]
    assert torch.all(filled[:, 1:] <= filled[:, :-1])


@pytest.mark.parametrize("seed", [0, 1])
def test_top_k_takes_lower_index_first_on_ties(seed):
    """The port's top-k picks what lax.top_k picks, ties included."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (64, 8)).astype(np.float32) / 4.0   # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = tmoe._top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _ffn_inputs(t=48, d=32, e=4, f=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    wg = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    wu = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    wo = (rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32)
    return x, router, wg, wu, wo


@pytest.mark.parametrize("top_k,capacity_factor", [
    (2, 1.25), (2, 0.5), (1, 2.0), (2, 4.0)])
def test_moe_ffn_matches_jax(top_k, capacity_factor):
    args = _ffn_inputs(seed=top_k)
    kw = dict(top_k=top_k, capacity_factor=capacity_factor)
    jout, jaux = j_moe_ffn(*map(jnp.asarray, args), **kw)
    tout, taux = tmoe.moe_ffn(*map(torch.from_numpy, args), **kw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_moe_ffn_gradients_match_jax():
    """Gradients of a weighted sum of the output plus the aux loss with
    respect to the tokens, the router and the three expert weights (the
    router's gradient comes through the combine weights and the aux
    loss)."""
    args = _ffn_inputs(seed=3)
    w = np.random.default_rng(4).standard_normal(
        (args[0].shape[0], args[0].shape[1])).astype(np.float32)

    def jloss(*a):
        out, aux = jmoe.moe_ffn(*a, top_k=2, capacity_factor=1.0)
        return jnp.sum(out * w) + aux

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out, aux = tmoe.moe_ffn(*ts, top_k=2, capacity_factor=1.0)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux, ts)
    for name, g, wg in zip(("x", "router", "wi_gate", "wi_up", "wo"),
                           got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_moe_ffn_bf16_matches_jax():
    """In bf16 (router float32) the port rounds the intermediates JAX
    rounds (dispatch and combine, the experts' inputs, hidden activations
    and outputs) after float32 accumulation: the outputs agree to one bf16
    ulp of their scale."""
    x, router, wg, wu, wo = _ffn_inputs(t=64, d=64, f=128, seed=5)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, wg, wu, wo)]
    jout, jaux = j_moe_ffn(bf[0], jnp.asarray(router), *bf[1:], top_k=2,
                           capacity_factor=1.25)

    def tb(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    tout, taux = tmoe.moe_ffn(tb(bf[0]), torch.from_numpy(router),
                              *map(tb, bf[1:]), top_k=2,
                              capacity_factor=1.25)
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout.astype(jnp.float32))
    assert np.abs(tout.float().numpy() - want).max() <= \
        2.0 ** -8 * np.abs(want).max()
    assert abs(float(taux) - float(jaux)) <= 1e-6
