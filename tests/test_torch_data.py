"""The port's ``DataIterator`` (``data/iterator.py``) against the JAX
package's, on the CPU: the same numpy blocks give the same batches from
``iter_batches`` (re-batching, the carry, ``drop_last``) and from
``iter_torch_batches`` on the CPU as from ``iter_jax_batches`` (values,
shapes and dtypes), across batch sizes. The card's side-stream copy is
driven on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from ray_tpu import data as rdata
from ray_tpu_torch.data.iterator import DataIterator

ROWS, BLOCKS = 53, 5


@pytest.fixture
def rt(ray_tpu_start):
    return ray_tpu_start


def _columns():
    rng = np.random.default_rng(3)
    return {"tokens": rng.integers(0, 1000, (ROWS, 9)).astype(np.int32),
            "weight": rng.random(ROWS).astype(np.float32)}


def _blocks(columns):
    """The blocks ``rdata.from_numpy(columns, num_blocks=BLOCKS)`` makes."""
    return [{k: v[i * ROWS // BLOCKS:(i + 1) * ROWS // BLOCKS]
             for k, v in columns.items()} for i in range(BLOCKS)]


def _same(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            w_np = np.asarray(w[k])
            g_np = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
            assert g_np.shape == w_np.shape, k
            assert np.dtype(g_np.dtype) == np.dtype(w_np.dtype), k
            np.testing.assert_array_equal(g_np, w_np)


@pytest.mark.parametrize("batch_size", [None, 1, 7, 16, 53, 64])
@pytest.mark.parametrize("drop_last", [False, True])
def test_iter_batches_match_jax(rt, batch_size, drop_last):
    columns = _columns()
    want = list(rdata.from_numpy(columns, num_blocks=BLOCKS).iterator()
                .iter_batches(batch_size=batch_size, drop_last=drop_last))
    got = list(DataIterator(_blocks(columns)).iter_batches(
        batch_size=batch_size, drop_last=drop_last))
    _same(got, want)


@pytest.mark.parametrize("batch_size,drop_last,prefetch", [
    (8, True, 1), (8, False, 2), (20, True, 0), (None, True, 1)])
@pytest.mark.parametrize("cast", [False, True])
def test_iter_torch_batches_match_iter_jax_batches(rt, batch_size,
                                                   drop_last, prefetch,
                                                   cast):
    columns = _columns()
    jax_dtypes = {"tokens": np.float32, "weight": np.float16} if cast \
        else None
    torch_dtypes = {"tokens": torch.float32, "weight": torch.float16} \
        if cast else None
    want = list(rdata.from_numpy(columns, num_blocks=BLOCKS).iterator()
                .iter_jax_batches(batch_size=batch_size,
                                  drop_last=drop_last, dtypes=jax_dtypes,
                                  prefetch=prefetch))
    got = list(DataIterator(_blocks(columns)).iter_torch_batches(
        batch_size=batch_size, drop_last=drop_last, dtypes=torch_dtypes,
        device="cpu", prefetch=prefetch))
    _same(got, want)
    assert all(t.device.type == "cpu" for b in got for t in b.values())


def test_torch_batches_own_their_memory():
    """A CPU batch is a copy: writing to it leaves the blocks alone."""
    columns = _columns()
    batch = next(DataIterator(_blocks(columns)).iter_torch_batches(
        batch_size=4, device="cpu"))
    batch["tokens"].zero_()
    assert columns["tokens"][:4].any()


def test_iter_torch_batches_defaults_to_the_card():
    """With no device given the feed targets the card, and raises on a
    host without one rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        next(DataIterator(_blocks(_columns())).iter_torch_batches(
            batch_size=4))
