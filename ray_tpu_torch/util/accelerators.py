"""Accelerator type constants (reference:
``python/ray/util/accelerators/accelerators.py:9-11``: accelerator
generations as schedulable resource labels, e.g.
``@remote(resources={TPU_V5P: 1})``).

JAX's TPU labels and ``tpu_generation_from_kind`` are kept as they are,
and beside them the card's counterpart, as ``num_tpus=`` became
``num_gpus=``: NVIDIA generations as labels, and
``gpu_generation_from_name`` mapping ``torch.cuda.get_device_name()``
to one.
"""

from __future__ import annotations

TPU_V2 = "TPU-V2"
TPU_V3 = "TPU-V3"
TPU_V4 = "TPU-V4"
TPU_V5E = "TPU-V5LITEPOD"
TPU_V5P = "TPU-V5P"
TPU_V6E = "TPU-V6E"

ALL_TPU_TYPES = (TPU_V2, TPU_V3, TPU_V4, TPU_V5E, TPU_V5P, TPU_V6E)


def tpu_generation_from_kind(device_kind: str) -> str | None:
    """Map a JAX ``device_kind`` string to the resource label."""
    kind = device_kind.lower()
    for label in ALL_TPU_TYPES:
        gen = label.split("-", 1)[1].lower()
        if gen in kind.replace(" ", ""):
            return label
    if "v5 lite" in kind or "v5e" in kind:
        return TPU_V5E
    if "v6 lite" in kind or "v6e" in kind:
        return TPU_V6E
    return None


# the reference's NVIDIA labels (accelerators.py)
NVIDIA_B200 = "B200"
NVIDIA_H200 = "H200"
NVIDIA_H100 = "H100"
NVIDIA_L40S = "L40S"
NVIDIA_L4 = "L4"
NVIDIA_A100 = "A100"
NVIDIA_A10G = "A10G"
NVIDIA_TESLA_V100 = "V100"
NVIDIA_TESLA_T4 = "T4"

ALL_GPU_TYPES = (NVIDIA_B200, NVIDIA_H200, NVIDIA_H100, NVIDIA_L40S,
                 NVIDIA_A100, NVIDIA_A10G, NVIDIA_TESLA_V100,
                 NVIDIA_TESLA_T4, NVIDIA_L4)


def gpu_generation_from_name(device_name: str) -> str | None:
    """Map a ``torch.cuda.get_device_name()`` string (for example
    ``"NVIDIA H100 80GB HBM3"``) to the resource label."""
    words = device_name.upper().replace("-", " ").split()
    return next((label for label in ALL_GPU_TYPES if label in words), None)

