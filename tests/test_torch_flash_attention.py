"""The port's flash-attention forward against ray_tpu's Pallas kernel.

On the CPU the port's wrapper runs its plain version (the blocked
online-softmax loop that the CUDA kernel computes); the JAX side runs the
Pallas kernel in interpret mode, as tests/test_flash_attention.py does.
Tolerances: float32 on both sides with other block sizes (summation
order only), 1e-4; bf16 inputs at 3e-2, the JAX package's own bf16
tolerance. The CUDA kernel itself is checked by the test marked ``cuda``
(skipped without a card) and by chip_smoke.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import _flash_fwd
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu_torch.ops.attention import reference_attention
from ray_tpu_torch.ops.flash_attention import (flash_attention, flash_fwd,
                                               flash_fwd_plain)


def _qkv(b, s, h, hk, d, skv=None, seed=0):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, hk, d)).astype(np.float32),
            rng.standard_normal((b, skv, hk, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("gqa", [1, 4])
def test_plain_flash_matches_jax_kernel(causal, gqa):
    q, k, v = _qkv(2, 256, 4, 4 // gqa, 64)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=128, block_k=128, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_plain_flash_uneven_blocks():
    q, k, v = _qkv(1, 384, 2, 2, 64)   # 3 x 128: uneven block walk
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, block_q=128, block_k=128, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_plain_flash_bf16():
    q, k, v = _qkv(1, 256, 2, 2, 64)
    want = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                     causal=True, block_q=128, block_k=128, interpret=True)
    got = flash_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                            for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("gqa", [1, 4])
def test_flash_fwd_lse_matches_jax(causal, gqa):
    """The lse mode, on the kernel layout [b, h, s, d]: out and lse
    against the Pallas forward's (lse lane-broadcast over 8 there)."""
    q, k, v = (x.transpose(0, 2, 1, 3).copy()
               for x in _qkv(1, 256, 4, 4 // gqa, 64, seed=3))
    scale = 64 ** -0.5
    want_out, want_lse = _flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        causal=causal, block_q=128, block_k=128, interpret=True,
        with_lse=True)
    launches = flash_fwd.launches
    out, lse = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal, with_lse=True)
    assert flash_fwd.launches == launches   # the plain version never counts
    assert lse.shape == (1, 4, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               rtol=1e-5, atol=1e-5)
    out2, lse2 = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal)
    assert lse2 is None
    np.testing.assert_array_equal(out2.numpy(), out.numpy())


def test_flash_mask_is_top_left_aligned():
    """With sq < skv the flash mask keeps k_pos <= q_pos (top left), as
    the Pallas kernel does; reference_attention aligns bottom right."""
    q, k, v = _qkv(1, 128, 2, 2, 64, skv=256, seed=4)
    want_out, want_lse = _flash_fwd(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
        scale=0.125, causal=True, block_q=128, block_k=128, interpret=True,
        with_lse=True)
    out, lse = flash_fwd(*(torch.from_numpy(x).transpose(1, 2)
                           for x in (q, k, v)), causal=True, with_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               rtol=1e-5, atol=1e-5)
    # top left: only the first 128 keys are visible, so the output equals
    # attention over k[:, :128]
    head = reference_attention(*(torch.from_numpy(x) for x in
                                 (q, k[:, :128], v[:, :128])))
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), head.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s", [200, 333])
def test_ragged_lengths_are_a_superset(s):
    """JAX rejects lengths that are neither multiples of 128 nor one
    block; the port takes them (its kernel masks the ragged tail)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, s, 4, 2, 64, seed=5))
    with pytest.raises(ValueError, match="multiple of 128"):
        jax_flash(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                  block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(flash_attention(q, k, v).numpy(),
                               reference_attention(q, k, v).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_fully_masked_row_guard():
    """A row with no visible key gives output 0 and lse -inf (the
    kernel's guard); with the top-left causal mask key 0 is always
    visible, so the guard is reached through a zero-length kv."""
    q = torch.randn(1, 2, 4, 64)
    kv = torch.zeros(1, 2, 0, 64)
    out, lse = flash_fwd_plain(q, kv, kv, scale=0.125, causal=True,
                               with_lse=True)
    assert torch.equal(out, torch.zeros_like(q))
    assert torch.isneginf(lse).all()


def test_block_args_are_accepted_and_ignored():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 256, 2, 2, 64, seed=6))
    a = flash_attention(q, k, v, block_q=128, block_k=256)
    b = flash_attention(q, k, v)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card (bf16 at the
    Llama-3-8B attention widths, and float32 with a ragged tail)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # max-abs and per-row relative limits of chip_smoke.py's K1 check
    for (b, h, hk, s, d, dt, tol, row_tol) in [
            (1, 32, 8, 512, 128, torch.bfloat16, 8e-3, 1e-2),
            (1, 4, 2, 200, 64, torch.float32, 1e-5, 1e-5)]:
        q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(dt)
        k = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(dt)
        v = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(dt)
        before = flash_fwd.launches
        out, lse = flash_fwd(q, k, v, with_lse=True)
        assert flash_fwd.launches == before + 1
        want, want_lse = flash_fwd_plain(q, k, v, scale=d ** -0.5,
                                         causal=True, with_lse=True)
        torch.cuda.synchronize()
        diff = (out.double() - want.double()).norm(dim=-1)
        assert (out.float() - want.float()).abs().max() <= tol
        assert (diff / want.double().norm(dim=-1)).max() <= row_tol
        assert (lse - want_lse).abs().max() <= 1e-4
