"""Weight carry-over from the JAX package's parameter pytree.

The one bridge between the two packages' weights: the caller converts the
JAX pytree with ``np.asarray`` (``jax.tree.map(np.asarray, params)``) and
hands the numpy tree here. Names and layouts are the same on both sides
(stacked ``[L, ...]`` blocks, ``x @ W`` orientation), so the mapping is
name for name.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def _to_tensor(a, device, dtype):
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes provides it): carry
        # the bits across unchanged
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .astype(np.int16)).view(torch.bfloat16)
    else:
        # a copy: the tree's arrays may be read-only views of JAX buffers
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(cfg, tree: dict, *, device="cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """The port's parameter dictionary from a numpy parameter tree.
    ``dtype`` casts every weight (default: keep each array's own dtype)."""
    dev = resolve_device(device)
    expected = {"embedding", "blocks", "final_norm"}
    if not cfg.tie_embeddings:
        expected.add("lm_head")
    if set(tree) != expected:
        raise ValueError(f"parameter tree has keys {sorted(tree)}, "
                         f"expected {sorted(expected)}")

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _to_tensor(node, dev, dtype)

    return convert(tree)
