"""Task and actor bodies for the port's metrics and log plane tests.

Module level, importing no JAX and no torch at import: the port carries
them to its cluster's workers by stdlib pickle, by reference, and a cold
worker imports this file.
"""

import sys


def attributed():
    import ray_tpu_torch

    print("attr-line-one-corge")
    print("attr-line-two-corge")
    return ray_tpu_torch.get_runtime_context().get_task_id()


def speak(word):
    print(f"proc-tail-sentinel-{word}")
    return 1


def observed(value):
    """Observes one histogram value in the worker's registry."""
    import ray_tpu_torch
    from ray_tpu_torch.util import metrics

    metrics.histogram("t_worker_seconds", "a worker's observation",
                      boundaries=(0.1, 1.0)).observe(value)
    return ray_tpu_torch.get_runtime_context().get_worker_id()


def flood(n):
    for i in range(n):
        print(f"flood-line-{i:03d}-waldo")
    return 1


def trickle():
    print("post-flood-trickle-fred")
    return 2


def boom(i):
    raise ValueError(f"boom-sentinel error #{i}")


class Chatter:
    def chat(self, text):
        import ray_tpu_torch

        print(text, file=sys.stderr)
        return ray_tpu_torch.get_runtime_context().get_task_id()
