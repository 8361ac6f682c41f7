"""The port's readers and writers (``ray_tpu_torch/data/``) against the
JAX package's on the CPU: JSON, CSV, text, binary files, parquet (with a
column projection and a ``file://`` URI), arrow, pandas, TFRecord (with
its CRC check), avro (both codecs, a hand-built file, the refusals),
WebDataset, images (decode, resize, grayscale), SQL on sqlite and Mongo
on a fake collection. Each reader reads the same files in both packages
and the rows must be equal bit for bit (values and dtypes); each writer's
files must equal JAX's byte for byte where the format has no writer
stamp, and read back the same rows otherwise; files written by one
package are read by the other. A missing optional package (``pyarrow``,
``pandas``, ``PIL``) raises an ``ImportError`` that names it.
"""

import io
import json
import sqlite3
import sys
import tarfile

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu.data import avro as javro
from ray_tpu.data import tfrecord as jtfr
from ray_tpu_torch import data as tdata
from ray_tpu_torch.data import avro as tavro
from ray_tpu_torch.data import tfrecord as ttfr

PACKAGES = (jdata, tdata)


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=4, num_tpus=0)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()


def norm(x):
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tolist())
    if isinstance(x, np.generic):
        return (str(x.dtype), x.item())
    return x


def both(fn):
    """``fn(data_module)`` for JAX and the port: equal, bit for bit."""
    want, got = (norm(fn(d)) for d in PACKAGES)
    assert got == want
    return got


def _table(d, n=16):
    return d.from_numpy({"k": np.arange(n) % 3,
                         "x": np.arange(n, dtype=np.float64)})


def test_json_csv_text_binary(runtimes, tmp_path):
    jp = tmp_path / "d.jsonl"
    jp.write_text('{"a": 1}\n{"a": 2, "b": "x"}\n')
    cp = tmp_path / "d.csv"
    cp.write_text("x,y\n1,2\n3,4\n")
    tp = tmp_path / "a.txt"
    tp.write_text("hello\r\nworld\n\nlast\n")
    bp = tmp_path / "blob.bin"
    bp.write_bytes(b"\x00\x01\x02")
    got = both(lambda d: (
        d.read_json(str(jp)).take_all(), d.read_csv(str(cp)).take_all(),
        d.read_csv(f"file://{cp}").take_all(),
        d.read_text(str(tp)).take_all(),
        d.read_text(str(tp), drop_empty=False).take_all(),
        d.read_text(f"file://{tp}").take_all(),
        d.read_binary_files(str(bp), include_paths=True).take_all()))
    assert [r["text"] for r in got[3]] == ["hello", "world", "last"]


def test_writers_write_jax_files(runtimes, tmp_path):
    """``write_csv`` and ``write_json`` write JAX's bytes; each package
    reads the other's files."""
    for d, name in ((jdata, "jax"), (tdata, "torch")):
        _table(d, 6).write_csv(str(tmp_path / name / "csv"))
        _table(d, 6).write_json(str(tmp_path / name / "json"))
    for kind in ("csv", "json"):
        jfiles = sorted((tmp_path / "jax" / kind).iterdir())
        tfiles = sorted((tmp_path / "torch" / kind).iterdir())
        assert [f.name for f in jfiles] == [f.name for f in tfiles]
        assert [f.read_bytes() for f in jfiles] == \
            [f.read_bytes() for f in tfiles]
    both(lambda d: (
        d.read_csv([str(p) for p in sorted(
            (tmp_path / ("torch" if d is jdata else "jax") / "csv")
            .glob("*.csv"))]).take_all(),
        d.read_json([str(p) for p in sorted(
            (tmp_path / ("torch" if d is jdata else "jax") / "json")
            .glob("*.json"))]).take_all()))


def test_parquet_arrow_pandas(runtimes, tmp_path):
    import pandas as pd
    import pyarrow as pa

    for d, name in ((jdata, "jax"), (tdata, "torch")):
        _table(d).write_parquet(str(tmp_path / name))
    # each package reads the other's files; a projection; a file:// URI
    got = both(lambda d: (
        d.read_parquet(str(tmp_path / ("torch" if d is jdata else "jax")))
        .take_all(),
        d.read_parquet(str(tmp_path / "jax"), columns=["k"]).take_all(),
        d.read_parquet(f"file://{tmp_path / 'torch'}").take_all()))
    assert len(got[0]) == 16
    table = pa.table({"x": list(range(10)),
                      "y": [f"r{i}" for i in range(10)]})
    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    both(lambda d: (
        d.from_arrow(table).take_all(),
        sorted(d.from_arrow(table).map_batches(lambda b: {"x2": b["x"] * 2})
               .to_arrow().column("x2").to_pylist()),
        d.from_pandas(df, num_blocks=2).take_all(),
        d.from_pandas(df).to_pandas().to_dict("list"),
        [list(r) for r in d.from_numpy(
            {"emb": np.arange(8.0).reshape(4, 2)}).to_pandas()["emb"]]))


def test_tfrecord_both_ways_and_crc(runtimes, tmp_path):
    rows = [{"label": 3, "name": "cat", "scores": [0.5, 1.5]},
            {"label": 7, "name": "dog", "scores": [2.0]},
            {"label": 1, "name": b"raw-bytes", "scores": [0.0, -1.0, 4.0]},
            {"label": -5, "name": "neg", "scores": [1.0]}]
    paths = {}
    for d, name in ((jdata, "jax"), (tdata, "torch")):
        paths[name] = str(tmp_path / f"{name}.tfrecord")
        d.write_tfrecords_file(rows, paths[name])
    assert open(paths["jax"], "rb").read() == \
        open(paths["torch"], "rb").read()
    got = both(lambda d: d.read_tfrecords(
        paths["torch" if d is jdata else "jax"]).take_all())
    assert got[0]["name"] == b"cat" and got[1]["scores"] == 2.0
    framed = bytearray(ttfr.frame_record(ttfr.build_example({"x": 1})))
    assert bytes(framed) == jtfr.frame_record(jtfr.build_example({"x": 1}))
    framed[14] ^= 0xFF    # flip a payload byte
    with pytest.raises(ValueError, match="CRC"):
        list(ttfr.iter_records(bytes(framed)))
    payload = bytes(range(256)) * 5 + b"tail"
    assert ttfr._crc32c(payload) == jtfr._crc32c(payload)
    assert ttfr._crc32c(b"123456789") == 0xE3069283   # Castagnoli


def _avro_rows():
    return [{"id": i, "name": f"row{i}", "score": i * 0.5,
             "flag": i % 2 == 0, "blob": bytes([i]),
             "tags": [f"t{i}", "x"], "attrs": {"k": i}} for i in range(25)]


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_container_both_ways(runtimes, tmp_path, codec):
    rows = _avro_rows()
    data = tavro.write_avro(rows, codec=codec, block_records=7)
    assert data == javro.write_avro(rows, codec=codec, block_records=7)
    assert list(tavro.iter_avro(data)) == rows
    p1, p2 = str(tmp_path / "a.avro"), str(tmp_path / "b.avro")
    jdata.write_avro_file(rows[:10], p1, codec=codec)
    tdata.write_avro_file(rows[10:], p2, codec=codec)
    got = both(lambda d: d.read_avro([p1, p2]).take_all())
    assert len(got) == 25


def test_avro_units_and_refusals():
    for n in (0, 1, -1, 63, 64, -65, 1 << 20, (1 << 62), -(1 << 62)):
        out = io.BytesIO()
        tavro._write_long(out, n)
        assert tavro._read_long(io.BytesIO(out.getvalue())) == n
        jout = io.BytesIO()
        javro._write_long(jout, n)
        assert out.getvalue() == jout.getvalue()
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "color", "type": {"type": "enum", "name": "Color",
                                   "symbols": ["RED", "GREEN", "BLUE"]}},
        {"name": "sig", "type": {"type": "fixed", "name": "Sig",
                                 "size": 4}}]}
    rows = [{"color": "GREEN", "sig": b"\x01\x02\x03\x04"}]
    assert list(tavro.iter_avro(tavro.write_avro(rows, schema))) == rows
    mixed = [{"a": None}, {"a": 5}, {"a": 2.5}, {"a": "s"}, {"a": True},
             {"a": b"b"}]
    assert list(tavro.iter_avro(tavro.write_avro(mixed))) == mixed
    sample = {"i": 1, "f": 2.0, "b": True, "s": "x", "z": b"q", "l": [1],
              "m": {"k": "v"}, "n": None}
    assert tavro.infer_schema(sample) == javro.infer_schema(sample)
    assert list(tavro.iter_avro(tavro.write_avro(
        [{"i": np.int64(7), "f": np.float32(0.5), "b": np.bool_(True)}]))) \
        == [{"i": 7, "f": 0.5, "b": True}]
    with pytest.raises(TypeError, match="long"):
        tavro.write_avro([{"x": 1}, {"x": 2.7}])
    with pytest.raises(ValueError, match="4 bytes"):
        tavro.write_avro([{"sig": b"abc"}], {
            "type": "record", "name": "r", "fields": [{"name": "sig", "type": {
                "type": "fixed", "name": "Sig", "size": 4}}]})
    bad = bytearray(tavro.write_avro([{"a": 1}]))
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="sync"):
        list(tavro.iter_avro(bytes(bad)))
    # a file built from the spec, independent of either writer
    meta = json.dumps({"type": "record", "name": "t", "fields": [
        {"name": "n", "type": "long"},
        {"name": "s", "type": "string"}]}).encode()

    def vint(n):
        out = io.BytesIO()
        tavro._write_long(out, n)
        return out.getvalue()

    body = vint(7) + vint(2) + b"hi" + vint(-3) + vint(2) + b"yo"
    buf = (tavro.MAGIC + vint(1) + vint(11) + b"avro.schema"
           + vint(len(meta)) + meta + vint(0) + b"S" * 16
           + vint(2) + vint(len(body)) + body + b"S" * 16)
    assert list(tavro.iter_avro(buf)) == [{"n": 7, "s": "hi"},
                                          {"n": -3, "s": "yo"}]


def test_webdataset(runtimes, tmp_path):
    tar_path = tmp_path / "shard-000.tar"
    with tarfile.open(tar_path, "w") as tar:
        for key, cls, txt in (("s1", 0, "hello"), ("d.x/s2", 4, "world")):
            for ext, payload in (("cls", str(cls).encode()),
                                 ("txt", txt.encode()),
                                 ("json", b'{"a": [1, 2]}'),
                                 ("bin", b"\x00\x01")):
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))
    got = both(lambda d: d.read_webdataset(str(tar_path)).take_all())
    assert [r["__key__"] for r in got] == ["s1", "d.x/s2"]


@pytest.fixture
def image_dir(tmp_path):
    from PIL import Image

    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        arr = rng.integers(0, 255, size=(40, 40, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f"img_{i:02d}.png")
    (d / "notes.txt").write_text("not an image")
    return str(d)


def test_images(runtimes, image_dir):
    got = both(lambda d: (
        rows_by_path(d.read_images(image_dir, size=(32, 24),
                                   include_paths=True).take_all()),
        rows_by_path(d.read_images(image_dir, size=(16, 16), mode="L",
                                   include_paths=True).take_all())))
    assert got[0][0]["image"][2] == (32, 24, 3)
    for d in PACKAGES:
        with pytest.raises(FileNotFoundError):
            d.read_images("/definitely/not/a/dir/xyz")


def rows_by_path(rows):
    """The decode tasks finish in any order: by path."""
    return sorted(rows, key=lambda r: r["path"])


@pytest.fixture
def db(tmp_path):
    path = str(tmp_path / "t.db")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE users (id INTEGER, name TEXT, score REAL)")
    conn.executemany("INSERT INTO users VALUES (?, ?, ?)",
                     [(i, f"user{i}", i * 1.5) for i in range(20)])
    conn.commit()
    conn.close()
    return path


def test_sql_on_sqlite(runtimes, db, tmp_path):
    got = both(lambda d: (
        d.read_sql("SELECT * FROM users ORDER BY id",
                   lambda: sqlite3.connect(db)).take_all(),
        d.read_sql("SELECT id, score FROM users WHERE id >= 15",
                   lambda: sqlite3.connect(db)).take_all(),
        sorted(r["id"] for r in d.read_sql(
            "SELECT id FROM users", lambda: sqlite3.connect(db))
            .map(lambda r: {"id": r["id"] * 2}).take_all())))
    assert got[0][0] == {"id": 0, "name": "user0", "score": 0.0}
    for d, name in ((jdata, "jax"), (tdata, "torch")):
        out = str(tmp_path / f"{name}.db")
        conn = sqlite3.connect(out)
        conn.execute("CREATE TABLE t (id INTEGER, score REAL)")
        conn.commit()
        conn.close()
        ds = d.read_sql("SELECT id, score FROM users WHERE id < 5",
                        lambda: sqlite3.connect(db))
        ds.write_sql("INSERT INTO t VALUES (?, ?)",
                     lambda: sqlite3.connect(out))
    dumps = []
    for name in ("jax", "torch"):
        conn = sqlite3.connect(str(tmp_path / f"{name}.db"))
        dumps.append(conn.execute("SELECT * FROM t ORDER BY id").fetchall())
        conn.close()
    assert dumps[0] == dumps[1] and len(dumps[1]) == 5


class _FakeCollection:
    """pymongo Collection double (``tests/test_sql_datasource.py``'s)."""

    def __init__(self, store):
        self.store = store

    def find(self, query=None, projection=None):
        rows = [dict(d) for d in self.store]
        if query:
            rows = [r for r in rows
                    if all(r.get(k) == v for k, v in query.items())]
        if projection:
            keep = {k for k, v in projection.items() if v}
            rows = [{k: r[k] for k in r if k in keep or k == "_id"}
                    for r in rows]
        return iter(rows)

    def insert_many(self, docs):
        self.store.extend(dict(d) for d in docs)


def test_mongo_on_a_fake_collection(runtimes):
    store = [{"_id": i, "name": f"u{i}", "score": i * 2} for i in range(8)]
    got = both(lambda d: (
        d.read_mongo(lambda: _FakeCollection(store)).take_all(),
        d.read_mongo(lambda: _FakeCollection(store),
                     query={"name": "u3"}).take_all(),
        d.read_mongo(lambda: _FakeCollection(store),
                     projection={"score": 1}).take_all()))
    assert got[0][0]["_id"] == "0"
    sinks = []
    for d in PACKAGES:
        sink: list = []
        d.write_mongo(d.read_mongo(lambda: _FakeCollection(store[:5])),
                      lambda s=sink: _FakeCollection(s))
        sinks.append(norm(sink))
    assert sinks[0] == sinks[1] and len(sinks[1]) == 5


@pytest.mark.parametrize("hidden,call", [
    ("pyarrow", lambda tmp: tdata.read_parquet(str(tmp))),
    ("pyarrow", lambda tmp: tdata.range(3).write_parquet(str(tmp / "o"))),
    ("pyarrow", lambda tmp: tdata.read_csv(f"file://{tmp}/x.csv").count()),
    ("pandas", lambda tmp: tdata.range(3).to_pandas()),
    ("PIL", lambda tmp: tdata.read_images(str(tmp / "i.png"))),
])
def test_a_missing_package_is_named(runtimes, tmp_path, monkeypatch,
                                    hidden, call):
    """With the package hidden (a ``None`` stand-in in ``sys.modules``
    makes its import raise), the call raises an ``ImportError`` that
    names it."""
    (tmp_path / "i.png").write_bytes(b"\x89PNG")
    (tmp_path / "x.csv").write_text("a\n1\n")
    for name in list(sys.modules):
        if name == hidden or name.startswith(hidden + "."):
            monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, hidden, None)
    with pytest.raises(ImportError, match=hidden):
        call(tmp_path)
