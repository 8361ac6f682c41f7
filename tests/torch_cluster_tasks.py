"""Tasks and actors of ``tests/test_torch_cluster.py``, in a module of
their own that imports no torch at module level: a cold port worker that
runs them imports this module by reference, and torch alone costs it
seconds. The JAX package's workers get this module by value
(``cloudpickle.register_pickle_by_value``)."""

import importlib
import os
import time

import numpy as np

# the node id each package's workers find in their environment
NODE_ENV = {"ray_tpu": "RAY_TPU_NODE_ID", "ray_tpu_torch": "RAY_TPU_TORCH_NODE_ID"}


def add(a, b):
    return a + b


def pid():
    return os.getpid()


def double(x):
    return 2 * x


def boom():
    raise ValueError("kaboom")


def sleep_then(i, seconds):
    time.sleep(seconds)
    return i


def node_of(pkg_name):
    return os.environ[NODE_ENV[pkg_name]]


def produce():
    return np.ones(50_000, dtype=np.float32)


def consume(arr):
    return float(arr.sum())


def add_nested(pkg_name, pair):
    api = importlib.import_module(pkg_name)
    x, y = pair
    return api.get(x) + api.get(y)


def passthrough(refs):
    return refs


def die_once(path):
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write("x")
        os._exit(1)          # a crash on the first attempt
    return "second attempt"


def die():
    os._exit(1)


def describe(tree):
    """What a worker received: each tensor's dtype, shape and bytes."""
    import torch

    return {k: (str(v.dtype), list(v.shape), v.view(torch.uint8).numpy()
                .tobytes() if v.dtype == torch.bfloat16 else
                v.numpy().tobytes()) for k, v in tree["t"].items()}


def tensors_back(tree):
    return tree


class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, k=1):
        self.n += k
        return self.n

    def value(self):
        return self.n


class Registry:
    def __init__(self):
        self.d = {}

    def set(self, k, v):
        self.d[k] = v
        return True

    def get(self, k):
        return self.d.get(k)


class Pinger:
    def ping(self):
        return "pong"

    def pid(self):
        return os.getpid()


class NodeOf:
    def node(self, pkg_name):
        return os.environ[NODE_ENV[pkg_name]]


def kv_read(pkg_name, key):
    """The internal KV's value of ``key``, read in a worker process."""
    kv = importlib.import_module(f"{pkg_name}.experimental")
    return kv.internal_kv_get(key)


def set_env(name, value):
    os.environ[name] = value


def read_env(name):
    return os.environ.get(name)
