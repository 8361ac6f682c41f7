"""The port's speculative decoding against its own greedy decode and
against ray_tpu.models.speculative, on the CPU.

The load-bearing property: for ANY draft, greedy speculative output is
the target's own greedy decode; drafts affect speed only. Weights come
from JAX's ``init_params`` and carry across through
``convert.params_from_numpy``. The models run in float32, where every
comparison is exact: token ids and the acceptance statistics must be
equal, not close (argmax ties at float32 rounding do not occur on these
seeded inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models.speculative import \
    speculative_generate as jax_speculative_generate
from ray_tpu_torch import convert
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.decoding import SamplingParams, generate
from ray_tpu_torch.models.speculative import speculative_generate

VOCAB = 128


def _draft_cfg(module):
    return module.LlamaConfig(
        vocab_size=VOCAB, d_model=64, n_layers=1, n_heads=2, n_kv_heads=2,
        d_ff=128, head_dim=32, remat="none", dtype="float32")


@pytest.fixture(scope="module")
def models():
    """(JAX side, port side): each a dict of target, independent draft and
    a noisy copy of the target (a draft that agrees part of the time)."""
    jt = dataclasses.replace(jllama.llama_tiny(VOCAB), dtype="float32")
    tt = dataclasses.replace(tllama.llama_tiny(VOCAB), dtype="float32")
    jd, td = _draft_cfg(jllama), _draft_cfg(tllama)
    pt = jax.tree.map(np.asarray, jllama.init_params(jt, jax.random.key(0)))
    pd = jax.tree.map(np.asarray, jllama.init_params(jd, jax.random.key(1)))
    rng = np.random.default_rng(2)
    noisy = jax.tree.map(
        lambda w: w + 0.3 * w.std() * rng.standard_normal(w.shape)
        .astype(np.float32), pt)
    jax_side = {"target": (jt, jax.tree.map(jnp.asarray, pt)),
                "draft": (jd, jax.tree.map(jnp.asarray, pd)),
                "noisy": (jt, jax.tree.map(jnp.asarray, noisy))}
    port = {"target": (tt, convert.params_from_numpy(tt, pt, device="cpu")),
            "draft": (td, convert.params_from_numpy(td, pd, device="cpu")),
            "noisy": (tt, convert.params_from_numpy(tt, noisy,
                                                    device="cpu"))}
    return jax_side, port


def _prompts():
    return np.array([[5, 9, 17, 33, 2, 0, 0, 0],
                     [7, 7, 7, 7, 7, 7, 7, 7]], dtype=np.int32)


def _greedy(port, n, eos_id=None):
    cfg, params = port["target"]
    return generate(cfg, params, torch.from_numpy(_prompts()),
                    sampling=SamplingParams(temperature=0.0,
                                            max_new_tokens=n),
                    eos_id=eos_id)


def _spec(port, draft, **kw):
    (cfg_t, p_t), (cfg_d, p_d) = port["target"], port[draft]
    return speculative_generate(cfg_t, p_t, cfg_d, p_d,
                                torch.from_numpy(_prompts()), **kw)


def test_exact_vs_target_greedy_independent_draft(models):
    """An unrelated random draft must not change the output."""
    _, port = models
    got = _spec(port, "draft", k_spec=4, max_new_tokens=24)
    assert torch.equal(got, _greedy(port, 24))


def test_perfect_draft_accepts_everything(models):
    """draft == target -> every proposal accepted: rounds collapse to
    about max_new / (k+1) and the output stays exact."""
    _, port = models
    got, stats = _spec(port, "target", k_spec=4, max_new_tokens=24,
                       return_stats=True)
    assert torch.equal(got, _greedy(port, 24))
    rounds = stats["rounds"]
    # 24 tokens at up to 5 a round -> 5 rounds; allow one slack round
    assert rounds <= 6, rounds
    assert int(stats["accepted"].sum()) >= 2 * rounds


@pytest.mark.parametrize("k", [1, 2, 7])
def test_various_k(models, k):
    _, port = models
    got = _spec(port, "draft", k_spec=k, max_new_tokens=17)
    assert torch.equal(got, _greedy(port, 17)), k


def test_eos_stops_and_pads(models):
    """Whatever token the target emits 3rd becomes EOS; the output must
    pad after it exactly like the plain decoder."""
    _, port = models
    eos = int(_greedy(port, 20)[0, 3])
    want = _greedy(port, 20, eos_id=eos)
    got = _spec(port, "draft", k_spec=4, max_new_tokens=20, eos_id=eos)
    assert torch.equal(got, want)
    assert (got[0, 4:] == 0).all()


@pytest.mark.parametrize("draft,k,eos_at", [
    ("draft", 4, None),
    ("target", 4, None),
    ("noisy", 3, None),
    ("noisy", 5, 6),
    ("target", 2, 9),
])
def test_tokens_and_stats_match_jax(models, draft, k, eos_at):
    """Tokens, rounds and per-row accepted counts equal JAX's
    speculative_generate on the same weights (EOS taken from row 0 of the
    greedy output at ``eos_at``)."""
    jax_side, port = models
    n_new = 20
    eos = None if eos_at is None else int(_greedy(port, n_new)[0, eos_at])
    (cfg_t, p_t), (cfg_d, p_d) = jax_side["target"], jax_side[draft]
    want, want_stats = jax_speculative_generate(
        cfg_t, p_t, cfg_d, p_d, jnp.asarray(_prompts()), k_spec=k,
        max_new_tokens=n_new, eos_id=eos, return_stats=True)
    got, stats = _spec(port, draft, k_spec=k, max_new_tokens=n_new,
                       eos_id=eos, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["rounds"] == int(want_stats["rounds"])
    np.testing.assert_array_equal(stats["accepted"].numpy(),
                                  np.asarray(want_stats["accepted"]))
    if draft == "noisy":   # the noisy draft agrees part of the time
        assert 0 < int(stats["accepted"].sum()) < stats["rounds"] * k * 2


def test_output_builds_no_graph_and_keeps_the_prompt_device(models):
    _, port = models
    got = _spec(port, "draft", k_spec=2, max_new_tokens=5)
    assert got.shape == (2, 5) and got.dtype == torch.int32
    assert got.device.type == "cpu" and got.grad_fn is None
