"""The port's ``util.multiprocessing``, ``util.joblib_backend``,
``util.iter`` and ``experimental`` (``tqdm_ray``, ``internal_kv``,
``free``) against the JAX package's on the CPU: the scenarios of
``tests/test_util_extras.py`` run through both packages' in-process
runtimes (started once for the module), the results equal. Then the
workflow's events through the internal KV, and ``joblib_backend`` with
``joblib`` hidden.
"""

import importlib
import json
import os
import subprocess
import sys
import time

import pytest

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": ray_tpu, "torch": ray_tpu_torch}


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def mod(pkg, name: str):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def both(scenario) -> dict:
    return {name: scenario(pkg) for name, pkg in PACKAGES.items()}


def _sq(x):
    return x * x


def _init_env(v):
    os.environ["POOL_INIT_V"] = str(v)


def _read_env(_):
    return os.environ.get("POOL_INIT_V")


def test_pool_map_apply_starmap_imap(runtimes):
    def scenario(pkg):
        Pool = mod(pkg, "util.multiprocessing").Pool
        with Pool(4) as pool:
            r = pool.apply_async(_sq, (5,))
            out = [pool.map(_sq, range(10)), pool.apply(_sq, (7,)),
                   r.get(timeout=10), r.successful(),
                   pool.map(_sq, range(7), chunksize=3)]
        with Pool(2) as pool:
            out += [pool.starmap(lambda a, b: a + b, [(1, 2), (3, 4)]),
                    list(pool.imap(_sq, [1, 2, 3])),
                    sorted(pool.imap_unordered(_sq, [1, 2, 3]))]
        return out

    got = both(scenario)
    assert got["torch"] == got["jax"] == [
        [x * x for x in range(10)], 49, 25, True, [x * x for x in range(7)],
        [3, 7], [1, 4, 9], [1, 4, 9]]


def test_pool_closed_initializer_and_pending(runtimes):
    def scenario(pkg):
        Pool = mod(pkg, "util.multiprocessing").Pool
        pool = Pool(2)
        pool.close()
        try:
            pool.apply_async(_sq, (1,))
            closed = "no error"
        except ValueError:
            closed = "ValueError"
        os.environ.pop("POOL_INIT_V", None)
        with Pool(2, initializer=_init_env, initargs=(9,)) as pool:
            init = pool.map(_read_env, [0])
        os.environ.pop("POOL_INIT_V", None)
        with Pool(2) as pool:
            r = pool.apply_async(lambda: (time.sleep(0.5), 1)[1])
            try:
                r.successful()
                pending = "no error"
            except ValueError:
                pending = "ValueError"
            done = [r.get(timeout=10), r.successful()]
            bad = pool.apply_async(_sq, ("x",))
            bad.wait(timeout=10)
            failed = [bad.ready(), bad.successful()]
        return [closed, init, pending, done, failed]

    got = both(scenario)
    assert got["torch"] == got["jax"] == [
        "ValueError", ["9"], "ValueError", [1, True], [True, False]]


def test_joblib_backend(runtimes):
    import joblib

    def scenario(pkg):
        mod(pkg, "util.joblib_backend").register_ray()
        with joblib.parallel_backend("ray_tpu"):
            return joblib.Parallel(n_jobs=4)(
                joblib.delayed(_sq)(i) for i in range(8))

    got = both(scenario)
    assert got["torch"] == got["jax"] == [i * i for i in range(8)]
    backend = mod(ray_tpu_torch, "util.joblib_backend").RayTpuBackend
    assert issubclass(backend, joblib.parallel.ParallelBackendBase)
    assert backend().effective_n_jobs(-1) == 8


JOBLIB_HIDDEN = r"""
import json, sys
sys.modules["joblib"] = None
import ray_tpu_torch.util.joblib_backend as jb
try:
    jb.register_ray()
    err = None
except ImportError as e:
    err = str(e)
try:
    jb.RayTpuBackend
    attr = None
except ImportError as e:
    attr = str(e)
print(json.dumps({"register": err, "attr": attr}))
"""


def test_joblib_backend_imports_without_joblib():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", JOBLIB_HIDDEN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "joblib" in got["register"] and "joblib" in got["attr"]


def test_parallel_iterator_and_branching(runtimes):
    def scenario(pkg):
        it_mod = mod(pkg, "util.iter")
        it = it_mod.from_range(12, num_shards=3)
        out = [sorted(it.for_each(lambda x: x * 2)
                      .filter(lambda x: x % 4 == 0).gather_sync())]
        it2 = it_mod.from_items(list(range(6)), num_shards=2).batch(2)
        batches = list(it2.gather_async())
        out += [sorted(x for b in batches for x in b), it2.num_shards]
        base = it_mod.from_range(10, num_shards=2)
        evens = base.filter(lambda x: x % 2 == 0)
        odds = base.filter(lambda x: x % 2 == 1)
        out += [sorted(evens.gather_sync()), sorted(odds.gather_sync()),
                sorted(base.gather_sync()),
                list(it_mod.from_iterators([[1, 2], [3]])
                     .flat_map(lambda x: [x, -x]).gather_sync()),
                it_mod.from_range(9, num_shards=3).take(4),
                len(base.shards())]
        return out

    got = both(scenario)
    assert got["torch"] == got["jax"] == [
        [0, 4, 8, 12, 16, 20], list(range(6)), 2, [0, 2, 4, 6, 8],
        [1, 3, 5, 7, 9], list(range(10)), [1, 3, -1, -3, 2, -2],
        [0, 1, 2, 3], 2]


def test_tqdm_ray(runtimes):
    def scenario(pkg):
        tqdm_ray = mod(pkg, "experimental").tqdm_ray

        def work(n):
            bar = tqdm_ray.tqdm(desc="work", total=n)
            for _ in range(n):
                bar.update(1)
            snap = tqdm_ray.snapshot()
            bar.close()
            return snap

        snap = pkg.get(pkg.remote(work).remote(5))
        seen = list(tqdm_ray.tqdm(range(3), desc="iter"))
        bar = tqdm_ray.tqdm(desc="open", total=4)
        bar.update(2)
        live = tqdm_ray.snapshot()

        class Sink:
            text = ""

            def write(self, s):
                self.text += s

        sink = Sink()
        rendered = tqdm_ray.render(sink)
        bar.close()
        return [sorted((b["desc"], b["n"], b["total"]) for b in snap.values()),
                seen, sorted((b["desc"], b["n"]) for b in live.values()),
                rendered, sink.text, tqdm_ray.snapshot()]

    got = both(scenario)
    assert got["torch"] == got["jax"]
    assert got["jax"][0] == [("work", 5, 5)]
    assert got["jax"][3] == "open: |##########----------| 2/4"


def test_internal_kv_local(runtimes):
    def scenario(pkg):
        kv = mod(pkg, "experimental")
        return [kv.internal_kv_put("k1", b"v1"), kv.internal_kv_get("k1"),
                kv.internal_kv_put("k1", b"v2", overwrite=False),
                kv.internal_kv_get(b"k1"), "k1" in kv.internal_kv_list("k"),
                kv.internal_kv_put("k2", 12), kv.internal_kv_get("k2"),
                kv.internal_kv_del("k1"), kv.internal_kv_del("k1"),
                kv.internal_kv_get("k1"), kv.internal_kv_del("k2")]

    got = both(scenario)
    assert got["torch"] == got["jax"] == [True, b"v1", False, b"v1", True,
                                          True, b"12", True, False, None,
                                          True]


def test_free_leaves_an_object_unreadable(runtimes):
    def scenario(pkg):
        free = mod(pkg, "experimental").free
        exc = mod(pkg, "utils.exceptions")
        a, b = pkg.put([1, 2]), pkg.put("b")
        before = pkg.get(a)
        free(a)
        free([b])
        out = [before]
        for ref in (a, b):
            try:
                pkg.get(ref, timeout=0.1)
                out.append("read")
            except exc.GetTimeoutError:
                out.append("GetTimeoutError")
        return out

    got = both(scenario)
    assert got["torch"] == got["jax"] == [[1, 2], "GetTimeoutError",
                                          "GetTimeoutError"]


def test_workflow_events_live_in_the_internal_kv(runtimes):
    """Both packages' workflow events are internal KV entries: a signal
    is read through ``internal_kv_get``, a cleared one is gone, and an
    entry put through the KV fires the event's step."""
    def scenario(pkg):
        wf, kv = mod(pkg, "workflow"), mod(pkg, "experimental")
        wf.signal_event("ready", b"go")
        signalled = kv.internal_kv_get("__wf_event_ready")
        wf.clear_event("ready")
        cleared = kv.internal_kv_get("__wf_event_ready")
        kv.internal_kv_put("__wf_event_put", b"via kv")
        node = wf.event("put", poll_interval_s=0.01, timeout_s=5)
        fired = pkg.get(node.execute())
        wf.clear_event("put")
        return [signalled, cleared, fired]

    got = both(scenario)
    assert got["torch"] == got["jax"] == [b"go", None, b"via kv"]
