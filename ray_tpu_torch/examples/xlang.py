"""Functions callable from external-language clients by descriptor
(``ray_tpu_torch.examples.xlang:add`` etc. — see ``runtime/xlang.py`` and the
C++ API in ``csrc/capi/``). A copy of ``ray_tpu/examples/xlang.py``."""


def add(a, b):
    return a + b


def concat(parts):
    return "".join(parts)


def stats(xs):
    return {"n": len(xs), "sum": float(sum(xs)),
            "max": float(max(xs)), "min": float(min(xs))}
