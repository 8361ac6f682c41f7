"""The port's flash-attention backward against ray_tpu's Pallas kernels.

On the CPU the port's backward runs its plain versions (the blocked
loops of K2 and K3, which the fused CUDA kernel computes in one launch);
the JAX side runs
the Pallas backward in interpret mode, as tests/test_flash_attention.py
does. Both sides get the same q, k, v, dO (numpy seeds) and the same
forward output and lse (from JAX's forward), so only the backward is
compared. Tolerances: float32 at 2e-3 (the JAX package's own flash
gradient tolerance; the two sides sum in other orders and blocks) and
bf16 at 3e-2 (its bf16 tolerance: both round P and dS to bf16 at the
same points, but the bf16 roundings of those values flip on different
summation orders). The CUDA kernel is checked by the test marked
``cuda`` (skipped without a card) and by chip_smoke.py on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import _flash_bwd, _flash_fwd
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops.attention import attention, reference_attention


def _arrays(b, h, hk, s, d, seed=0):
    """q, k, v, dO on the kernel layout [b, heads, s, d], float32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, hk, s, d)).astype(np.float32),
            rng.standard_normal((b, hk, s, d)).astype(np.float32),
            rng.standard_normal((b, h, s, d)).astype(np.float32))


def _jax_backward(q, k, v, do, *, causal, dtype):
    """JAX's forward (out, lse) and Pallas backward (interpret mode)."""
    scale = q.shape[-1] ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    out, lse = _flash_fwd(jq, jk, jv, scale=scale, causal=causal,
                          block_q=128, block_k=128, interpret=True,
                          with_lse=True)
    grads = _flash_bwd(jq, jk, jv, out, lse, jdo, scale=scale,
                       causal=causal, block_q=128, block_k=128,
                       interpret=True)
    return out, lse, grads


def _torch(x, dtype):
    return torch.from_numpy(np.array(x, np.float32).copy()).to(dtype)


@pytest.mark.parametrize("s", [256, 384])
@pytest.mark.parametrize("gqa", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_jax_kernels_f32(causal, gqa, s):
    """flash_bwd (K2 and K3's plain versions) against _flash_bwd; s 384 is
    three 128-blocks, an uneven causal block walk."""
    q, k, v, do = _arrays(1, 4, 4 // gqa, s, 64, seed=s + gqa)
    out, lse, want = _jax_backward(q, k, v, do, causal=causal,
                                   dtype=jnp.float32)
    launches = fa.flash_bwd.launches
    got = fa.flash_bwd(*(torch.from_numpy(x) for x in (q, k, v)),
                       _torch(out, torch.float32),
                       _torch(np.asarray(lse)[..., 0], torch.float32),
                       torch.from_numpy(do), scale=64 ** -0.5, causal=causal)
    # the plain versions never count as launches
    assert fa.flash_bwd.launches == launches
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_jax_kernels_bf16(causal):
    q, k, v, do = _arrays(1, 4, 1, 256, 64, seed=7)
    out, lse, want = _jax_backward(q, k, v, do, causal=causal,
                                   dtype=jnp.bfloat16)
    bf = torch.bfloat16
    got = fa.flash_bwd(*(_torch(x, bf) for x in (q, k, v)), _torch(out, bf),
                       _torch(np.asarray(lse)[..., 0], torch.float32),
                       _torch(do, bf), scale=64 ** -0.5, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == bf, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=3e-2,
                                   atol=3e-2, err_msg=name)


@pytest.mark.parametrize("h,hk,d,dtype,tol", [
    (8, 2, 128, jnp.float32, 2e-3),
    (8, 2, 128, jnp.bfloat16, 3e-2),
    (4, 2, 256, jnp.float32, 2e-3),
], ids=["d128_gqa4_f32", "d128_gqa4_bf16", "d256_gqa2_f32"])
def test_plain_backward_matches_jax_at_main_path_widths(h, hk, d, dtype, tol):
    """The fused kernel's plain version (flash_bwd on the CPU) against
    _flash_bwd at the head widths the main path runs: Llama-3-8B's d 128
    with its GQA group of 4, and d 256, causal, in two 128-blocks."""
    q, k, v, do = _arrays(1, h, hk, 256, d, seed=d + h)
    out, lse, want = _jax_backward(q, k, v, do, causal=True, dtype=dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = fa.flash_bwd(*(_torch(x, tdt) for x in (q, k, v)),
                       _torch(out, tdt),
                       _torch(np.asarray(lse)[..., 0], torch.float32),
                       _torch(do, tdt), scale=d ** -0.5, causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tdt and g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("gqa", [1, 2])
def test_flash_attention_grad_matches_jax(gqa):
    """The port's differentiable flash_attention against jax.grad of JAX's
    flash_attention (interpret mode), on [b, s, h, d] with a weighted-sum
    loss (tests/test_flash_attention.py:95-116, same tolerances: 2e-3 for
    MHA, 2e-2 for GQA gradients)."""
    rng = np.random.default_rng(11 + gqa)
    b, s, h, d = 1, 256, 4, 64
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h // gqa, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h // gqa, d)).astype(np.float32)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=True, block_q=128,
                                 block_k=128, interpret=True) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                                for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    calls = fa.flash_fwd.calls
    out = fa.flash_attention(tq, tk, tv, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    assert fa.flash_fwd.calls == calls + 1   # the backward reran nothing
    tol = 2e-3 if gqa == 1 else 2e-2
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=tol,
                                   atol=tol)


def test_attention_dispatch_grad_matches_reference():
    """attention() differentiates on both of its paths; on the CPU "flash"
    goes through the plain backward, against autograd of the reference
    attention."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .requires_grad_() for shape in ((2, 256, 4, 32),
                                               (2, 256, 2, 32),
                                               (2, 256, 2, 32)))
    do = torch.from_numpy(rng.standard_normal((2, 256, 4, 32))
                          .astype(np.float32))
    got = torch.autograd.grad(attention(q, k, v, impl="flash"), (q, k, v), do)
    want = torch.autograd.grad(reference_attention(q, k, v), (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_flash_fwd_lse_is_not_differentiable():
    q, k, v, _ = (torch.from_numpy(x).requires_grad_()
                  for x in _arrays(1, 2, 2, 128, 64, seed=3))
    out, lse = fa.flash_fwd(q, k, v, with_lse=True)
    assert out.requires_grad and not lse.requires_grad
    assert fa.FLASH_FWD_OP is torch.ops.ray_tpu_torch.flash_fwd.default


def test_fully_masked_row_has_zero_gradient():
    """A row with lse -inf (no visible key) gets a zero gradient in both
    plain versions, and adds nothing to dK/dV (JAX computes nan there)."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _arrays(1, 2, 1, 128, 64, seed=9))
    out, lse = fa.flash_fwd(q, k, v, causal=False, with_lse=True)
    masked_lse = lse.clone()
    masked_lse[:, :, 5] = float("-inf")
    dq, dk, dv = fa.flash_bwd(q, k, v, out, masked_lse, do, scale=0.125,
                              causal=False)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert torch.equal(dq[:, :, 5], torch.zeros_like(dq[:, :, 5]))
    # dV is P^T dO summed over rows: dropping row 5's dO gives the same
    do_wo = do.clone()
    do_wo[:, :, 5] = 0.0
    _, _, dv_wo = fa.flash_bwd(q, k, v, out, masked_lse, do_wo,
                               scale=0.125, causal=False)
    torch.testing.assert_close(dv, dv_wo)


def test_backward_takes_strided_layouts():
    """dO from autograd comes as [b, s, h, d]; the backward takes its
    transposed view as it is and gives the contiguous result's values."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _arrays(2, 4, 2, 128, 64, seed=4))
    out, lse = fa.flash_fwd(q, k, v, with_lse=True)
    want = fa.flash_bwd(q, k, v, out, lse, do, scale=0.125)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in (q, k, v, out, do)]
    got = fa.flash_bwd(*strided[:4], lse, strided[4], scale=0.125)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)


@pytest.mark.cuda
def test_cuda_backward_kernels_match_plain():
    """The fused backward kernel (K2 and K3 in one launch) against their
    plain versions on the card (bf16 at the Llama-3-8B head widths,
    float32 with a ragged tail), one launch counted per backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # per-row relative limit of chip_smoke.py's backward check, its row floor
    for (b, h, hk, s, d, dt, tol) in [
            (1, 32, 8, 512, 128, torch.bfloat16, 1e-2),
            (1, 4, 2, 200, 64, torch.float32, 1e-5)]:
        q, do = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(dt)
                 for _ in range(2))
        k, v = (torch.randn(b, hk, s, d, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        out, lse = fa.flash_fwd(q, k, v, with_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        args, kw = (q, k, v, do, lse, delta), dict(scale=d ** -0.5)
        before = fa.flash_bwd.launches
        got = fa.flash_bwd(q, k, v, out, lse, do, **kw)
        assert fa.flash_bwd.launches == before + 1
        want = (fa.flash_bwd_dq_plain(*args, **kw),
                *fa.flash_bwd_dkv_plain(*args, **kw))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            norms = w.double().norm(dim=-1)
            floor = 1e-2 * norms.square().mean().sqrt()
            err = (g.double() - w.double()).norm(dim=-1) / \
                norms.clamp_min(floor)
            assert err.max() <= tol
