"""The port's Llama model against ray_tpu's, on the CPU.

JAX initializes the weights; they carry across through
``convert.params_from_numpy``. Both sides run ``llama_tiny`` in float32,
so logits differ only by float32 summation order: 1e-4 absolute on
logits of order 1, and 1e-5 relative on the loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tllama


def _pair(dtype="float32", tie=False):
    jcfg = dataclasses.replace(jllama.llama_tiny(), dtype=dtype,
                               tie_embeddings=tie)
    tcfg = dataclasses.replace(tllama.llama_tiny(), dtype=dtype,
                               tie_embeddings=tie)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tparams = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, shape=(2, 16), seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_configs_match_jax():
    for name in ("llama3_8b", "llama3_70b", "llama_tiny"):
        j = getattr(jllama, name)()
        t = getattr(tllama, name)()
        assert dataclasses.asdict(j) == dataclasses.asdict(t), name


def test_conversion_is_bit_exact_in_bf16():
    jcfg, jparams, tcfg, tparams = _pair(dtype="bfloat16")
    assert tparams["blocks"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tparams["blocks"]["wq"].float().numpy(),
        np.asarray(jparams["blocks"]["wq"], np.float32))
    assert tllama.num_params(tparams) == jllama.num_params(jparams)


def test_init_params_layout_matches_jax():
    cfg = tllama.llama_tiny()
    ours = tllama.init_params(cfg, seed=0, device="cpu")
    theirs = jllama.init_params(jllama.llama_tiny(), jax.random.key(0))
    for name, arr in theirs["blocks"].items():
        assert tuple(ours["blocks"][name].shape) == arr.shape, name
        assert ours["blocks"][name].dtype == torch.bfloat16
    assert tuple(ours["embedding"].shape) == theirs["embedding"].shape
    assert tuple(ours["lm_head"].shape) == theirs["lm_head"].shape
    # fan-in scaled: std of wq ~ d_model ** -0.5
    std = float(ours["blocks"]["wq"].float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    again = tllama.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["blocks"]["w_up"], ours["blocks"]["w_up"])


@pytest.mark.parametrize("tie", [False, True])
def test_forward_logits_match_jax(tie):
    jcfg, jparams, tcfg, tparams = _pair(tie=tie)
    toks = _tokens(jcfg)
    want = jllama.forward(jcfg, jparams, jnp.asarray(toks))
    got = tllama.forward(tcfg, tparams, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_forward_with_positions_and_segments_matches_jax():
    jcfg, jparams, tcfg, tparams = _pair()
    toks = _tokens(jcfg, (1, 16), seed=2)
    pos = np.concatenate([np.arange(8), np.arange(8)])[None].astype(np.int32)
    seg = np.array([[1] * 8 + [2] * 8], np.int32)
    want = jllama.forward(jcfg, jparams, jnp.asarray(toks),
                          positions=jnp.asarray(pos),
                          segment_ids=jnp.asarray(seg))
    got = tllama.forward(tcfg, tparams, torch.from_numpy(toks).long(),
                         positions=torch.from_numpy(pos),
                         segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_flash_impl_matches_reference_on_cpu():
    """``attn_impl="flash"`` runs the kernel's plain version on the CPU;
    with sq == skv its mask equals the reference's."""
    _, _, tcfg, tparams = _pair()
    toks = torch.from_numpy(_tokens(tcfg, (1, 256), seed=3)).long()
    a = tllama.forward(tcfg, tparams, toks, attn_impl="flash")
    b = tllama.forward(tcfg, tparams, toks, attn_impl="reference")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_loss_matches_jax(z_loss):
    jcfg, jparams, tcfg, tparams = _pair()
    toks = _tokens(jcfg, (2, 17), seed=4)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    mask = (np.random.default_rng(5).random(tgt.shape) > 0.3)
    jl = jllama.forward(jcfg, jparams, jnp.asarray(inp))
    tl = tllama.forward(tcfg, tparams, torch.from_numpy(inp).long())
    for m in (None, mask):
        want = jllama.cross_entropy_loss(
            jl, jnp.asarray(tgt), z_loss=z_loss,
            mask=None if m is None else jnp.asarray(m))
        got = tllama.cross_entropy_loss(
            tl, torch.from_numpy(tgt).long(), z_loss=z_loss,
            mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_forward_hidden_and_head():
    jcfg, jparams, tcfg, tparams = _pair()
    toks = _tokens(jcfg)
    want = jllama.forward_hidden(jcfg, jparams, jnp.asarray(toks))
    got = tllama.forward_hidden(tcfg, tparams, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert tllama.lm_head_weights(tcfg, tparams) is tparams["lm_head"]


def test_entry_points_default_to_cuda():
    """With no card, an entry point asked for nothing raises instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.init_params(tllama.llama_tiny())


def test_converter_rejects_foreign_trees():
    cfg = tllama.llama_tiny()
    with pytest.raises(ValueError, match="expected"):
        convert.params_from_numpy(cfg, {"embedding": np.zeros((2, 2))},
                                  device="cpu")
