"""ray_tpu_torch ops (norms, rope, attention) against ray_tpu's, on the CPU.

The same numpy inputs go through both packages. Tolerances: float32 on
both sides, differing only in summation order, so 1e-5 relative (2e-5
absolute on attention outputs, whose softmax sums differ in order); bf16
results compare within one bf16 ulp (2^-8 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rope as jrope
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import norms as tnorms
from ray_tpu_torch.ops import rope as trope


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_rms_norm_matches_jax():
    x, w = _rand(0, 4, 16), _rand(1, 16, scale=0.1) + 1.0
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_rms_norm_bf16_stats_in_fp32():
    x = torch.full((2, 8), 300.0).to(torch.bfloat16)
    out = tnorms.rms_norm(x, torch.ones(8, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.ones((2, 8)),
                               rtol=1e-2)


@pytest.mark.parametrize("bias", [False, True])
def test_layer_norm_matches_jax(bias):
    x, w, b = _rand(0, 3, 32), _rand(1, 32), _rand(2, 32)
    got = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b) if bias else None)
    want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(b) if bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rope_matches_jax():
    b, s, h, d = 2, 8, 2, 16
    x = _rand(0, b, s, h, d)
    pos = np.arange(3, 3 + s, dtype=np.int32)[None, :].repeat(b, 0)
    sin_t, cos_t = trope.rope_sin_cos(torch.from_numpy(pos), d,
                                      theta=10000.0)
    sin_j, cos_j = jrope.rope_sin_cos(jnp.asarray(pos), d, theta=10000.0)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    got = trope.apply_rope(torch.from_numpy(x), sin_t, cos_t)
    want = jrope.apply_rope(jnp.asarray(x), sin_j, cos_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        trope.rope_frequencies(d).numpy(),
        np.asarray(jrope.rope_frequencies(d)), rtol=1e-6)


def test_rope_bf16_casts_back():
    x = torch.from_numpy(_rand(0, 1, 4, 2, 8)).to(torch.bfloat16)
    sin, cos = trope.rope_sin_cos(torch.arange(4)[None], 8)
    out = trope.apply_rope(x, sin, cos)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        np.linalg.norm(out.float().numpy(), axis=-1),
        np.linalg.norm(x.float().numpy(), axis=-1), rtol=1e-2)


def _attn_pair(**kwargs):
    """(port, jax) reference attention on the same inputs."""
    sq, skv = kwargs.pop("sq", 16), kwargs.pop("skv", 16)
    h, hk, d = kwargs.pop("h", 4), kwargs.pop("hk", 2), 8
    q, k, v = _rand(0, 2, sq, h, d), _rand(1, 2, skv, hk, d), \
        _rand(2, 2, skv, hk, d)
    seg = kwargs.pop("segment_ids", None)
    got = tattn.reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segment_ids=None if seg is None else torch.from_numpy(seg),
        **kwargs)
    want = jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=None if seg is None else jnp.asarray(seg), **kwargs)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("case", [
    dict(causal=True), dict(causal=False), dict(causal=True, hk=4),
    dict(causal=True, sq=4, skv=16),               # decode offset
    dict(causal=True, logits_soft_cap=5.0),
    dict(causal=True, scale=0.3),
    dict(causal=True, segment_ids=np.array([[1] * 8 + [2] * 8,
                                            [1] * 4 + [2] * 12], np.int32)),
], ids=["causal", "noncausal", "mha", "decode_offset", "soft_cap", "scale",
        "segments"])
def test_reference_attention_matches_jax(case):
    got, want = _attn_pair(**case)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_reference_attention_bf16_matches_jax():
    q, k, v = (_rand(i, 1, 16, 2, 8) for i in range(3))
    got = tattn.reference_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    want = jattn.reference_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -8, atol=2 ** -8)


def test_attention_causality():
    q, k, v = (torch.from_numpy(_rand(i, 1, 8, 2, 8)) for i in range(3))
    out1 = tattn.reference_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 5:], v2[:, 5:] = 99.0, -99.0
    out2 = tattn.reference_attention(q, k2, v2)
    np.testing.assert_allclose(out1[:, :5].numpy(), out2[:, :5].numpy(),
                               rtol=1e-5)


def test_attention_dispatch_on_cpu():
    """On the CPU ``auto`` takes the reference path (the flash gate asks
    for a CUDA tensor); ``flash`` takes the kernel's plain version, which
    agrees with the reference when sq == skv."""
    q = torch.from_numpy(_rand(0, 1, 256, 4, 64))
    k = torch.from_numpy(_rand(1, 1, 256, 2, 64))
    v = torch.from_numpy(_rand(2, 1, 256, 2, 64))
    assert not tattn._flash_supported(q, None, None, True)
    ref = tattn.reference_attention(q, k, v)
    np.testing.assert_array_equal(tattn.attention(q, k, v).numpy(),
                                  ref.numpy())
    np.testing.assert_allclose(tattn.attention(q, k, v, impl="flash").numpy(),
                               ref.numpy(), rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="segment_ids"):
        tattn.attention(q, k, v, impl="flash",
                        segment_ids=torch.zeros(1, 256, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(q, k, v, impl="ring")


def test_flash_gate_matches_jax_rule():
    """The gate's shape rule is the JAX package's (s >= 256, s % 128 == 0,
    d in 64/128/256, causal, no segments or soft-cap); only "backend is
    TPU" became "tensor is on CUDA"."""
    meta = torch.empty((1, 256, 2, 64), device="meta")
    assert not tattn._flash_supported(meta, None, None, True)   # not CUDA
    for shape, causal, ok in [((1, 256, 2, 64), True, True),
                              ((1, 384, 2, 128), True, True),
                              ((1, 200, 2, 64), True, False),
                              ((1, 128, 2, 64), True, False),
                              ((1, 256, 2, 96), True, False),
                              ((1, 256, 2, 64), False, False)]:
        fake = type("T", (), {"is_cuda": True, "shape": shape})()
        assert tattn._flash_supported(fake, None, None, causal) is ok
    fake = type("T", (), {"is_cuda": True, "shape": (1, 256, 2, 64)})()
    assert not tattn._flash_supported(fake, None, 5.0, True)
