"""Quickstart: train a Llama-family model on a mesh of one card's places.

    python -m ray_tpu_torch.examples.train_llama

Port of ``ray_tpu/examples/train_llama.py``. JAX factors its devices into
a mesh; the port's mesh may place one card in every place, so this
factors PLACES places of one device the same way (4: {fsdp 2, tp 2}) and
trains ``llama_tiny`` under ``fsdp_tp`` on it.
Runs on the card; ``main(device="cpu")`` runs on the CPU.
"""

import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.train.trainer import TrainConfig, Trainer

PLACES = 4


def mesh_axes(n: int) -> dict:
    """JAX's factoring of ``n`` places: tp 2 on an even count; the rest
    becomes fsdp when it is a power of two (so parameter dimensions stay
    divisible), otherwise plain dp."""
    tp = 2 if n % 2 == 0 and n >= 2 else 1
    rest = n // tp
    pow2 = rest > 0 and (rest & (rest - 1)) == 0
    return {"dp": 1 if pow2 else rest, "fsdp": rest if pow2 else 1,
            "tp": tp}


def main(device="cuda") -> list:
    """Train 30 steps; returns the history (one entry every 10 steps)."""
    axes = mesh_axes(PLACES)
    mesh = create_mesh(axes, devices=[device] * PLACES)
    trainer = Trainer(
        llama.llama_tiny(),                    # swap for llama3_8b()
        TrainConfig(mesh_axes=axes, strategy="fsdp_tp", learning_rate=1e-3,
                    warmup_steps=5, total_steps=100),
        mesh=mesh, device=device,
    )
    state = trainer.init_state(seed=0)
    data_rows = axes["dp"] * axes["fsdp"]
    batch_size = data_rows * max(8 // data_rows, 1)   # a multiple of them

    def batches():
        i = 0
        while True:
            yield torch.randint(0, 512, (batch_size, 129),
                                generator=torch.Generator().manual_seed(i))
            i += 1

    state, history = trainer.fit(state, batches(), steps=30, log_every=10)
    for h in history:
        print({k: round(v, 4) for k, v in h.items()})
    return history


if __name__ == "__main__":
    main()
