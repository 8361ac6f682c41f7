"""The port's ``Dataset`` (``ray_tpu_torch/data/``) against the JAX
package's on the CPU: the scenarios of ``tests/test_data.py``,
``tests/test_data_extras.py`` and ``tests/test_data_images.py``'s
executor units, each run through ``ray_tpu.data`` and
``ray_tpu_torch.data`` on their in-process runtimes (started once for the
module). The results must be equal bit for bit (values and dtypes), since
both run the same numpy; they are sorted only where JAX's own order is
not fixed (task maps finish in any order). This covers both shuffles'
order for a seed, ``random_sample``, the preprocessors, the aggregates,
``streaming_split``'s rows for each split, the actor pool's scaling and
the executor's byte budget.
"""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu_torch import data as tdata

PACKAGES = {"jax": jdata, "torch": tdata}


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def norm(x):
    """A comparable form: numpy values carry their dtype."""
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tolist())
    if isinstance(x, np.generic):
        return (str(x.dtype), x.item())
    if isinstance(x, torch.Tensor):
        return norm(x.numpy())
    return x


def rows_sorted(rows, key=None):
    """Rows whose order a task map does not fix, in a fixed order."""
    return sorted(rows, key=key or (lambda r: repr(norm(r))))


def _table(d, n=20):
    return d.from_numpy({"k": np.arange(n) % 3,
                         "x": np.arange(n, dtype=np.float64)})


# --- the scenarios: each takes the package's data module ------------------


def range_count(d):
    return d.range(100).count()


def map_batches(d):
    ds = d.range(100, num_blocks=4).map_batches(
        lambda b: {"id": b["id"] * 2})
    return np.sort(np.concatenate([b["id"] for b in ds.iter_batches()]))


def map_and_filter_rows(d):
    return sorted(d.from_items(list(range(20))).map(lambda x: x + 1)
                  .filter(lambda x: x % 2 == 0).take_all())


def flat_map(d):
    return sorted(d.from_items([1, 2, 3], num_blocks=1).flat_map(
        lambda x: [x, x * 10]).take_all())


def limit(d):
    return d.range(1000).limit(17).take_all()


def repartition(d):
    bundles = list(d.range(100, num_blocks=10).repartition(3)
                   .iter_bundles())
    return [b.num_rows for b in bundles], \
        d.range(100, num_blocks=10).repartition(3).take_all()


def random_shuffle(d):
    return d.range(50).random_shuffle(seed=7).take_all()


def sort(d):
    return d.from_items([{"k": v} for v in [5, 3, 9, 1, 7]],
                        num_blocks=2).sort("k").take_all()


def union(d):
    a = d.from_items([1, 2], num_blocks=1)
    b = d.from_items([3, 4], num_blocks=1)
    return sorted(a.union(b).take_all())


def actor_pool(d):
    class Stateful:
        def __call__(self, batch):
            return {"id": batch["id"] + 1000}

    ds = d.range(40, num_blocks=4).map_batches(
        Stateful, compute="actors", actor_pool_size=2)
    return sorted(int(i) for b in ds.iter_batches() for i in b["id"])


def rebatch(d):
    return list(d.range(100, num_blocks=7).iterator().iter_batches(
        batch_size=32))


def streaming_split(d):
    """Each split's rows, then a second pass over the first (empty: a
    split is read once)."""
    splits = d.range(80, num_blocks=8).streaming_split(2)
    return [list(s.iter_rows()) for s in splits] + \
        [list(splits[0].iter_rows())]


def materialize_and_stats(d):
    ds = d.range(30, num_blocks=3).map_batches(lambda b: {"id": b["id"]})
    mat = ds.materialize()
    st = ds.stats()
    return mat.count(), st["MapBatches"]["tasks"], \
        st["MapBatches"]["rows_out"], "task wall" in st


def groupby_aggregates(d):
    return (_table(d, 9).groupby("k").sum("x").take_all(),
            _table(d, 9).groupby("k").count().take_all(),
            _table(d, 9).groupby("k").mean("x").take_all())


def groupby_multi_agg_and_std(d):
    a = d.aggregate
    return _table(d, 10).groupby("k").aggregate(
        a.Min("x"), a.Max("x"), a.Std("x", ddof=0)).take_all()


def global_aggregates(d):
    ds = _table(d, 10)
    a = d.aggregate
    return (ds.sum("x"), ds.min("x"), ds.max("x"), ds.mean("x"),
            ds.std("x"), ds.aggregate(a.Count(), a.Sum("x")))


def map_groups(d):
    out = _table(d, 9).groupby("k").map_groups(
        lambda g: {"k": g["k"][:1], "total": np.array([g["x"].sum()])}
    ).take_all()
    return rows_sorted(out, key=lambda r: int(r["k"]))


def zip_and_column_ops(d):
    a = d.from_numpy({"x": np.arange(6)})
    b = d.from_numpy({"y": np.arange(6) * 10})
    ds = d.from_numpy({"x": np.arange(4, dtype=np.float64)})
    ds2 = ds.add_column("sq", lambda b: b["x"] ** 2)
    # the column ops are task maps: their blocks come in any order
    return (a.zip(b).take_all(), rows_sorted(ds2.take_all()),
            rows_sorted(ds2.select_columns(["sq"]).take_all()),
            rows_sorted(ds2.drop_columns(["sq"]).take_all()),
            rows_sorted(ds2.rename_columns({"sq": "square"}).take_all()))


def unique_schema_split(d):
    ds = _table(d, 12)
    return (ds.unique("k"), {k: str(v) for k, v in ds.schema().items()},
            [p.take_all() for p in ds.split(3)],
            [p.count() for p in d.from_numpy({"x": np.arange(2)}).split(4)])


def push_based_shuffle(d):
    ctx = d.DataContext.get_current()
    ctx.use_push_based_shuffle = True
    try:
        return (d.range(100).random_shuffle(seed=7).take_all(),
                d.range(60).random_shuffle(seed=5).take_all())
    finally:
        ctx.use_push_based_shuffle = False


def standard_scaler(d):
    ds = d.from_numpy({"a": np.array([1.0, 2.0, 3.0, 4.0]),
                       "b": np.array([10.0, 10.0, 10.0, 10.0])})
    sc = d.preprocessors.StandardScaler(["a", "b"]).fit(ds)
    return sc.stats_, rows_sorted(sc.transform(ds).take_all())


def minmax_label_onehot(d):
    pp = d.preprocessors
    ds = d.from_items([{"x": 0.0, "cat": "a"}, {"x": 5.0, "cat": "b"},
                       {"x": 10.0, "cat": "a"}])
    return (rows_sorted(pp.MinMaxScaler(["x"]).fit(ds).transform(ds)
                        .take_all()),
            rows_sorted(pp.LabelEncoder("cat").fit(ds).transform(ds)
                        .take_all()),
            rows_sorted(pp.OneHotEncoder(["cat"]).fit(ds).transform(ds)
                        .take_all()))


def concat_chain_batchmapper(d):
    pp = d.preprocessors
    ds = d.from_numpy({"f1": np.arange(4, dtype=np.float64),
                       "f2": np.arange(4, dtype=np.float64) * 2})
    chain = pp.Chain(
        pp.StandardScaler(["f1"]),
        pp.BatchMapper(lambda b: {**b, "f2": b["f2"] + 1}),
        pp.Concatenator(["f1", "f2"], "features"),
    ).fit(ds)
    return rows_sorted(chain.transform(ds).take_all()), chain.transform_batch(
        {"f1": np.array([0.0, 3.0]), "f2": np.array([1.0, 1.0])})


def unfit_preprocessor_raises(d):
    try:
        d.preprocessors.StandardScaler(["x"]).transform(d.range(3))
    except RuntimeError as e:
        return str(e)
    return None


def random_sample(d):
    ds = d.from_numpy({"x": np.arange(80)}, num_blocks=8)
    return ds.random_sample(0.5, seed=1).take_all()


def zip_no_silent_overwrite(d):
    a = d.from_numpy({"k": np.arange(3), "k_1": np.arange(3) * 2})
    b = d.from_numpy({"k": np.arange(3) * 5})
    return a.zip(b).take_all()


def cpu_torch_batches(d):
    """JAX's CPU ``iter_torch_batches`` (drop_last False, no device) and
    the port's with ``device="cpu", drop_last=False``."""
    ds = d.range(100, num_blocks=4).map_batches(
        lambda b: {"x": np.asarray(b["id"], np.float32) * 2})
    kw = {} if d is jdata else {"device": "cpu", "drop_last": False}
    batches = list(ds.iterator().iter_torch_batches(batch_size=32, **kw))
    # the map tasks finish in any order, so the rows of a batch are not
    # fixed: the sizes, the dtype and the sorted values are
    x = torch.cat([b["x"] for b in batches])
    return [len(b["x"]) for b in batches], str(x.dtype), \
        sorted(x.tolist()), all(isinstance(b["x"], torch.Tensor)
                                for b in batches)


def tiny_byte_budget(d):
    ctx = d.DataContext.get_current()
    old = ctx.execution_budget_bytes
    ctx.execution_budget_bytes = 4096
    try:
        ds = d.range(200).map(lambda r: {"y": r["id"] * 2})
        return sorted(r["y"] for r in ds.take(1000))
    finally:
        ctx.execution_budget_bytes = old


def block_splitting(d):
    mod = __import__(f"{d.__name__}.execution", fromlist=["_maybe_split"])
    ctx = d.DataContext.get_current()
    old = ctx.target_max_block_size
    ctx.target_max_block_size = 1000
    try:
        rows = [{"x": np.zeros(100, np.float64)} for _ in range(10)]
        return [(len(p[0]), p[1], p[2]) for p in
                mod._maybe_split(rows, 10, 8000)]
    finally:
        ctx.target_max_block_size = old


def byte_budget(d):
    """The in-process runtime's store answers no ``stats()["capacity"]``
    in either package: a quarter of 1 GiB."""
    mod = __import__(f"{d.__name__}.execution", fromlist=["x"])
    return mod._resolve_byte_budget(mod.ExecutionOptions())


SCENARIOS = [range_count, map_batches, map_and_filter_rows, flat_map, limit,
             repartition, random_shuffle, sort, union, actor_pool, rebatch,
             streaming_split, materialize_and_stats, groupby_aggregates,
             groupby_multi_agg_and_std, global_aggregates, map_groups,
             zip_and_column_ops, unique_schema_split, push_based_shuffle,
             standard_scaler, minmax_label_onehot, concat_chain_batchmapper,
             unfit_preprocessor_raises, random_sample,
             zip_no_silent_overwrite, cpu_torch_batches, tiny_byte_budget,
             block_splitting, byte_budget]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(runtimes, scenario):
    want = norm(scenario(jdata))
    got = norm(scenario(tdata))
    assert got == want


def test_scenarios_hold_what_the_jax_tests_assert(runtimes):
    """The values the JAX tests assert, on the port's side (so a scenario
    that both packages got wrong alike would still fail)."""
    assert range_count(tdata) == 100
    assert [r["id"] for r in random_shuffle(tdata)] != list(range(50))
    assert sorted(int(r["id"]) for r in random_shuffle(tdata)) == \
        list(range(50))
    first, second = push_based_shuffle(tdata)
    assert [int(r["id"]) for r in first[:10]] != list(range(10))
    assert sorted(int(r["id"]) for r in second) == list(range(60))
    s0, s1, again = streaming_split(tdata)
    assert again == []
    assert s0 and s1 and sorted(int(r["id"]) for r in s0 + s1) == \
        list(range(80))
    assert [len(b["id"]) for b in rebatch(tdata)] == [32, 32, 32, 4]
    assert materialize_and_stats(tdata) == (30, 3, 30, True)
    assert {int(r["k"]): r["sum(x)"] for r in
            groupby_aggregates(tdata)[0]} == {0: 9.0, 1: 12.0, 2: 15.0}
    kept = [int(r["x"]) for r in random_sample(tdata)]
    assert len({k % 10 for k in kept}) > 5
    assert set(zip_no_silent_overwrite(tdata)[0]) == {"k", "k_1", "k_2"}
    assert tiny_byte_budget(tdata) == [2 * i for i in range(200)]
    assert len(block_splitting(tdata)) > 1
    assert byte_budget(tdata) == 256 << 20
    assert "must be fit" in unfit_preprocessor_raises(tdata)


def test_actor_pool_autoscales_and_retires(runtimes):
    """The actor pool grows from 1 under queued work and is empty after
    the drain, in both packages (reference: ActorPoolMapOperator)."""
    import time

    def slowish(batch):
        time.sleep(0.02)
        return batch

    for d in PACKAGES.values():
        mod = __import__(f"{d.__name__}.execution", fromlist=["x"])
        captured = []
        orig = mod.MapOperator.__init__

        def spy(self, *a, **k):
            orig(self, *a, **k)
            captured.append(self)

        mod.MapOperator.__init__ = spy
        try:
            rows = (d.range(400).map_batches(
                lambda: slowish, compute="actors", actor_pool_size=1,
                max_actor_pool_size=4).take_all())
        finally:
            mod.MapOperator.__init__ = orig
        assert len(rows) == 400
        op = next(o for o in captured if o.name == "MapBatches")
        assert op.metrics.get("actors_started", 0) >= 2, (d, op.metrics)
        assert len(op._pool) == 0


def test_data_pipeline_quickstart_prints_jax_rows(runtimes, capsys):
    """The port's ``examples/data_pipeline.py`` prints JAX's example's
    rows (each group's mean, float32) and returns them."""
    from ray_tpu.examples import data_pipeline as jax_example
    from ray_tpu_torch.examples import data_pipeline as port_example

    printed = []
    for example in (jax_example, port_example):
        rows = example.main()
        out = capsys.readouterr().out
        printed.append(out.split("Dataset execution")[0])
    assert printed[1] == printed[0]
    assert norm(rows) == norm([
        {"group": g, "mean(y)": np.float32(m)} for g, m in (
            (0, 9997.0), (1, 9999.0), (2, 10001.0), (4, 9998.0),
            (5, 10000.0), (6, 10002.0))])
