"""The port's kernel tuner on the CPU (``paddle_tpu_torch/kernels/tuning``)
against the JAX package's (``paddle_tpu/pallas/tuning``): the shape
buckets and the serving bucketer, the database's keys, round trip,
merge, atomic write, schema rejection and environment variable on the
documents of ``tests/test_tuning.py``; dispatch through each wrapper's
pure plan function (a valid hit changes the plan, a miss or a hit invalid
at the actual shape leaves it as it is, the empty database counts no
lookup); the tune loop with a stand-in for the card's timer; and the
``paddle tune`` command's exit codes.  Torch runs on one intra-op
thread."""

import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.pallas.tuning import bucket as jax_bucket
from paddle_tpu.pallas.tuning import db as jax_db
from paddle_tpu_torch import cli
from paddle_tpu_torch.kernels import batch_norm as kbn
from paddle_tpu_torch.kernels import conv as kconv
from paddle_tpu_torch.kernels import lstm as klstm
from paddle_tpu_torch.kernels import matmul as kmatmul
from paddle_tpu_torch.kernels import paged_attention as kpa
from paddle_tpu_torch.kernels import softmax as ksoftmax
from paddle_tpu_torch.kernels import tuning
from paddle_tpu_torch.kernels.tuning import bucket as tb
from paddle_tpu_torch.kernels.tuning import measure, space, tune
from paddle_tpu_torch.kernels.tuning.db import SCHEMA, TuningDB, make_key
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.serving import batching

F32, BF16 = torch.float32, torch.bfloat16
SMS = 132


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _isolated_db(monkeypatch):
    """Every test starts from an empty database and leaves none behind."""
    monkeypatch.delenv("PADDLE_TPU_TUNING_DB", raising=False)
    tuning.disable()
    yield
    tuning.set_db(None)


def _install(kernel, shape, dtype, cfg):
    db = TuningDB()
    db.put(kernel, shape, dtype, tuning.current_device_kind(),
           {"config": cfg})
    tuning.set_db(db)


def _lookups(kernel):
    c = metrics.REGISTRY.get("tuning_db_lookup_total")
    if c is None:
        return 0, 0
    return c.value(kernel=kernel, result="hit"), c.value(kernel=kernel,
                                                          result="miss")


# ---------------------------------------------------------------------------
# buckets (shared with the serving bucketer)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["bucket_dim", "bucket_ladder"])
def test_bucket_functions_equal_the_reference(fn):
    for n in range(0, 4097):
        assert getattr(tb, fn)(n) == getattr(jax_bucket, fn)(n), n


def test_bucket_shape_equals_the_reference():
    rng = np.random.RandomState(0)
    for _ in range(500):
        shape = tuple(int(d) for d in rng.randint(1, 4097, rng.randint(1, 7)))
        assert tb.bucket_shape(shape) == jax_bucket.bucket_shape(shape)
    assert tb.bucket_shape((3, 100, 128)) == (4, 128, 128)


def test_serving_bucketer_delegates(monkeypatch):
    for n in range(1, 4097):
        assert batching.next_bucket(n) == tb.bucket_dim(n)
    for n in (1, 5, 6, 8, 33, 4096):
        assert batching.bucket_ladder(n) == tb.bucket_ladder(n)
    calls = []
    monkeypatch.setattr(batching._bucket, "bucket_ladder",
                        lambda n: calls.append(n) or (7,))
    assert batching.bucket_ladder(3) == (7,) and calls == [3]


# ---------------------------------------------------------------------------
# the database, on the reference's documents
# ---------------------------------------------------------------------------


def test_make_key_equals_the_reference():
    for args in ((("matmul", (100, 100, 100), "float32", "cpu")),
                 ("softmax", (8, 1000), "float32", "nvidia_h100_80gb_hbm3"),
                 ("lstm", (100, 64, 257), "bfloat16", "cpu")):
        assert make_key(*args) == jax_db.make_key(*args)
    a = make_key("matmul", (100, 100, 100), "float32", "cpu")
    assert a == "matmul|128x128x128|float32|cpu"
    assert make_key("matmul", (129, 128, 128), "float32", "cpu") != a
    assert SCHEMA == jax_db.SCHEMA


def test_db_round_trip_crosses_packages(tmp_path):
    p = str(tmp_path / "db.json")
    db = TuningDB()
    db.put("matmul", (256, 512, 256), "float32", "cpu",
           {"config": {"bm": 128}, "time_ms": 1.0})
    db.save(p)
    for got in (TuningDB.load(p), jax_db.TuningDB.load(p)):
        assert got.lookup("matmul", (256, 512, 256), "float32",
                          "cpu") == {"bm": 128}
        assert got.lookup("matmul", (200, 500, 200), "float32",
                          "cpu") == {"bm": 128}
        assert got.lookup("matmul", (256, 512, 256), "bfloat16",
                          "cpu") is None
        assert got.lookup("matmul", (256, 512, 256), "float32",
                          "tpu_v4") is None
    q = str(tmp_path / "jax.json")
    jdb = jax_db.TuningDB()
    jdb.put("softmax", (512, 128), "float32", "cpu",
            {"config": {"block_rows": 64}})
    jdb.save(q)
    assert TuningDB.load(q).entries == jax_db.TuningDB.load(q).entries


def test_db_save_merges_not_clobbers(tmp_path):
    p = str(tmp_path / "db.json")
    a = TuningDB()
    a.put("softmax", (512, 128), "float32", "cpu",
          {"config": {"route": "staged", "cluster": 1}})
    a.save(p)
    b = TuningDB()
    b.put("matmul", (256, 512, 256), "float32", "cpu",
          {"config": {"wgmma_min_rows": 2048}})
    b.save(p)
    assert len(TuningDB.load(p)) == 2
    c = TuningDB()
    c.put("softmax", (512, 128), "float32", "cpu",
          {"config": {"route": "two-read", "cluster": 2}})
    c.save(p)
    got = TuningDB.load(p)
    assert got.lookup("softmax", (512, 128), "float32", "cpu") == {
        "route": "two-read", "cluster": 2}
    assert len(got) == 2
    assert got.entries == jax_db.TuningDB.load(p).entries


def test_db_atomic_write_no_stray_tmp(tmp_path):
    p = str(tmp_path / "db.json")
    db = TuningDB()
    db.put("softmax", (512, 128), "float32", "cpu", {"config": {}})
    db.save(p)
    db.save(p)
    assert os.listdir(tmp_path) == ["db.json"]


def test_db_schema_reject(tmp_path):
    p = str(tmp_path / "db.json")
    with open(p, "w") as f:
        json.dump({"schema": "paddle_tpu.tuning_db.v999",
                   "entries": {"k": {}}}, f)
    with pytest.raises(ValueError):
        TuningDB.load(p)
    with pytest.raises(ValueError):
        jax_db.TuningDB.load(p)
    assert len(TuningDB.load_or_empty(p)) == 0
    assert len(TuningDB.load_or_empty(str(tmp_path / "missing.json"))) == 0
    with open(p, "w") as f:
        f.write("{corrupt")
    assert len(TuningDB.load_or_empty(p)) == 0


def test_env_var_off_and_path(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TUNING_DB", "off")
    tuning.set_db(None)
    assert len(tuning.get_db()) == 0 and not tuning.live
    assert tuning.lookup("softmax", (512, 128), "float32") is None
    p = str(tmp_path / "db.json")
    db = TuningDB()
    db.put("softmax", (512, 128), "float32", tuning.current_device_kind(),
           {"config": {"route": "staged", "cluster": 2}})
    db.save(p)
    monkeypatch.setenv("PADDLE_TPU_TUNING_DB", p)
    tuning.set_db(None)
    assert tuning.live
    assert tuning.lookup("softmax", (500, 100), "float32") == {
        "route": "staged", "cluster": 2}
    assert tuning.live


def test_shipped_db_is_empty_and_counts_nothing(monkeypatch):
    """The shipped database: the schema, no entry; read through the
    environment's default it leaves ``live`` False, and no wrapper's plan
    function counts a lookup."""
    with open(tuning.DEFAULT_PATH) as f:
        doc = json.load(f)
    assert doc == {"schema": SCHEMA, "entries": {}}
    tuning.set_db(None)
    before = {k: _lookups(k) for k in space.SPACES}
    assert tuning.lookup("softmax", (8, 1000), "float32") is None
    assert not tuning.live
    ksoftmax.launch_plan(8, 1000, 0, 0)
    kmatmul.engine_of(8192, 2048, 2048, 0, 0, F32)
    kbn.launch_plan(4096, 64, F32, "vector")
    kconv.dw_launch_plan(2, 8, 8, 64, 64, 3, 1, F32, "wgmma")
    kpa.launch_chunk_plan(2, 4, 2, 16, 4, 8, SMS)
    assert {k: _lookups(k) for k in space.SPACES} == before


# ---------------------------------------------------------------------------
# dispatch: each family's plan function with and without an entry
# ---------------------------------------------------------------------------


def _plan_of(name, shape, dtype):
    """The wrapper's pure plan for ``shape`` as dispatch computes it now
    (the installed database)."""
    tdt = space._torch_dtype(dtype)
    if name == "softmax":
        return ksoftmax.launch_plan(*shape, 0, 0)
    if name == "matmul":
        return kmatmul.engine_of(*shape, 0, 0, tdt)
    if name == "conv_dw":
        n, h, w, c, o, k = shape
        return kconv.dw_launch_plan(n, h, w, c, o, k, k // 2, tdt,
                                    space._conv_dw_engine(shape, dtype))
    if name == "batch_norm":
        rows, cols = shape
        return kbn.launch_plan(rows, cols, tdt, kbn.route(cols, tdt, 0, 0))
    if name == "lstm":
        return klstm.tuned_rows_cluster(*shape, tdt, SMS)
    if name == "ragged_paged_attention_chunk":
        s, t, h, d, page, p = shape
        return kpa.launch_chunk_plan(s, t, h, d, p, page, SMS)
    raise KeyError(name)


def _default_plan(name, shape, dtype):
    """The wrapper's own plan by its rule, with no database."""
    tdt = space._torch_dtype(dtype)
    if name == "softmax":
        return ksoftmax.softmax_plan(shape[1], 0, 0)
    if name == "matmul":
        rule = (kmatmul.bf16_engine if dtype == "bfloat16"
                else kmatmul.f32_engine)
        return rule(*shape, 0, 0)
    if name == "conv_dw":
        n, h, w, c, o, k = shape
        engine = space._conv_dw_engine(shape, dtype)
        return kconv.dw_rule_plan(k * k * c, o, kconv.dw_reduction(
            n, h, w, k // 2, tdt, engine), tdt, engine)
    if name == "batch_norm":
        rows, cols = shape
        return kbn.plan(rows, cols, kbn._ITEMSIZE[tdt],
                        kbn.route(cols, tdt, 0, 0))
    if name == "lstm":
        return (0, 0)
    if name == "ragged_paged_attention_chunk":
        s, t, h, d, page, p = shape
        return kpa.chunk_plan(s, t, h, d, p, page, SMS)
    raise KeyError(name)


def _expect_applied(name, shape, dtype, cfg, got):
    if name == "softmax":
        assert got[:2] == (cfg["route"], cfg["cluster"])
    elif name == "matmul":
        assert got in ("simt", "mma.sync")
    elif name == "conv_dw":
        tdt = space._torch_dtype(dtype)
        n, h, w, c, o, k = shape
        kk = kconv.dw_reduction(n, h, w, k // 2, tdt, cfg["engine"])
        assert got == kconv.dw_split_chunk(kk, cfg["splits"],
                                           kconv.dw_kstep(tdt, cfg["engine"]))
    elif name == "batch_norm":
        tdt = space._torch_dtype(dtype)
        rows, cols = shape
        assert got == kbn.plan(rows, cols, kbn._ITEMSIZE[tdt],
                               kbn.route(cols, tdt, 0, 0),
                               cfg["blocks_per_sm"], cfg["min_rows"])
    elif name == "lstm":
        assert got == (cfg["rows"], cfg["cluster"])
    elif name == "ragged_paged_attention_chunk":
        assert got[0] == cfg["span"]


#: The families whose kernel has no launch parameter: the default alone.
_DEFAULT_ALONE = ("conv", "flash_attention", "ragged_paged_attention")

_CASES = [(name, shape, dtype)
          for name, fam in sorted(space.SPACES.items())
          if name not in _DEFAULT_ALONE
          for shape in fam.default_shapes + fam.smoke_shapes
          for dtype in fam.dtypes]


@pytest.mark.parametrize("name,shape,dtype", [
    (name, shape, dtype) for name in _DEFAULT_ALONE
    for shape in space.SPACES[name].default_shapes
    + space.SPACES[name].smoke_shapes
    for dtype in space.SPACES[name].dtypes])
def test_a_family_without_a_launch_parameter_lists_the_default_alone(
        name, shape, dtype):
    """The conv forward, the flash forward and the decode kernel have no
    launch parameter: their families offer no candidate, and say why."""
    fam = space.SPACES[name]
    assert fam.configs(shape, dtype, SMS) == []
    assert fam.note.startswith("the default alone")


@pytest.mark.parametrize("name,shape,dtype", _CASES)
def test_each_candidate_is_valid_and_a_hit_changes_the_plan(name, shape,
                                                            dtype):
    fam = space.SPACES[name]
    default = _default_plan(name, shape, dtype)
    assert _plan_of(name, shape, dtype) == default
    cands = fam.configs(shape, dtype, SMS)
    for cfg in cands:
        _install(name, shape, dtype, cfg)
        hits = _lookups(name)[0]
        got = _plan_of(name, shape, dtype)
        assert _lookups(name)[0] == hits + 1
        assert got != default, (cfg, got)
        _expect_applied(name, shape, dtype, cfg, got)
    # a miss (another shape's bucket) leaves the plan as it is
    if cands:
        other = tuple(2 * d for d in shape)
        _install(name, other, dtype, cands[0])
        assert _plan_of(name, shape, dtype) == default


#: Configs a wrapper's predicate refuses at the shape: the plan stays the
#: rule's.
_INVALID = {
    "softmax": ((8, 1000), [{"route": "staged", "cluster": 9},
                            {"route": "bogus", "cluster": 1},
                            {"route": "warp", "cluster": 1},
                            {"block_rows": 512}]),
    "matmul": ((8192, 2048, 2048), [{"wgmma_min_rows": 512},
                                    {"wgmma_min_rows": 1024}, {}]),
    "conv_dw": ((256, 56, 56, 256, 256, 3),
                [{"splits": 1, "engine": "wgmma"},
                 {"splits": 4, "engine": "mma.sync"}, {"splits": 0}]),
    "batch_norm": ((3211264, 64), [{"blocks_per_sm": 0},
                                   {"min_rows": 0}, {"block_rows": 512}]),
    "lstm": ((100, 64, 256), [{"rows": 5, "cluster": 2},
                              {"rows": 4, "cluster": 32}]),
    "ragged_paged_attention_chunk": ((16, 4, 16, 128, 16, 128),
                                     [{"span": 0}, {"span": 129},
                                      {"span": 2000}]),
}


@pytest.mark.parametrize("name", sorted(_INVALID))
def test_an_invalid_hit_leaves_the_plan(name):
    shape, cfgs = _INVALID[name]
    dtype = "bfloat16" if name == "conv_dw" else "float32"
    default = _default_plan(name, shape, dtype)
    for cfg in cfgs:
        _install(name, shape, dtype, cfg)
        assert _plan_of(name, shape, dtype) == default, cfg
    # the bf16 filter gradient's cap: one split of the 56 x 56 x 256
    # reduction would be 3,136 K steps, past 512
    assert kconv._WG_MAX_STEPS == 512


def test_a_hit_invalid_at_the_actual_shape_keeps_the_rule():
    """An entry valid at the bucket's shape, invalid at a shape of the
    bucket: a staged route for x and y at offsets 16 bytes apart, the LSTM
    rows of a cluster that do not split H, a span past P."""
    _install("softmax", (64, 40000), "float32",
             {"route": "staged", "cluster": 4})
    assert ksoftmax.launch_plan(64, 40000, 0, 0)[:2] == ("staged", 4)
    assert ksoftmax.launch_plan(64, 40000, 0, 4) == ksoftmax.softmax_plan(
        40000, 0, 4)
    _install("lstm", (100, 64, 32), "float32", {"rows": 4, "cluster": 16})
    assert klstm.tuned_rows_cluster(100, 64, 32, F32, SMS) == (4, 16)
    assert klstm.tuned_rows_cluster(100, 64, 20, F32, SMS) == (0, 0)
    _install("ragged_paged_attention_chunk", (2, 4, 2, 16, 8, 8), "float32",
             {"span": 8})
    assert kpa.launch_chunk_plan(2, 4, 2, 16, 5, 8, SMS) == kpa.chunk_plan(
        2, 4, 2, 16, 5, 8, SMS)
    assert kpa.launch_chunk_plan(2, 4, 2, 16, 8, 8, SMS) == (8, 1)


def test_the_reference_db_keeps_every_plan(monkeypatch):
    """The JAX package's shipped database read by the port (the schema is
    one): its configs name Pallas blocks, which no wrapper's predicate
    takes, so every plan stays the rule's."""
    from paddle_tpu.pallas.tuning.db import DEFAULT_PATH as JAX_DB

    monkeypatch.setenv("PADDLE_TPU_TUNING_DB", JAX_DB)
    tuning.set_db(None)
    assert len(tuning.get_db()) > 0
    for name, shape, dtype in _CASES:
        assert _plan_of(name, shape, dtype) == _default_plan(name, shape,
                                                             dtype)


def test_lookup_is_memoized_and_counted_once():
    _install("softmax", (8, 1000), "float32", {"route": "staged",
                                               "cluster": 1})
    hits, misses = _lookups("softmax")
    for _ in range(5):
        assert ksoftmax.launch_plan(8, 1000, 0, 0)[:2] == ("staged", 1)
        ksoftmax.launch_plan(64, 4096, 0, 0)
    assert _lookups("softmax") == (hits + 1, misses + 1)


# ---------------------------------------------------------------------------
# the tune loop with a stand-in timer
# ---------------------------------------------------------------------------


def test_tune_loop_enumerates_measures_persists_and_dispatches(tmp_path):
    out = str(tmp_path / "db.json")
    timed = []

    def fake_measure(family, case, shape, dtype, cfg, device_kind, reps):
        timed.append((family.name, cfg))
        out_t = case.run()   # the CPU: the wrapper's plain version
        err, limit = case.error(out_t)
        assert err <= limit
        if cfg is None:
            return 1.0, err
        if cfg.get("cluster") == 2 or cfg.get("rows") == 8:
            raise measure.Infeasible("stand-in: refused")
        return 0.5 + 0.01 * len(timed), err

    rows, saved, hits = tune.run_tune(
        ["softmax", "lstm", "ragged_paged_attention"], None, True, 3, 1,
        "float32", 0, out, torch.device("cpu"), "cpu", measure=fake_measure,
        sms=SMS, log=lambda *a: None)
    assert saved == out and hits == len(rows) == 4
    db = TuningDB.load(out)
    assert len(db) == 4
    for r in rows:
        rec = db.entries[make_key(r["kernel"], r["shape"], "float32", "cpu")]
        assert rec["config"] == r["config"]
        assert rec["n_measured"] <= 3
        if r["kernel"] == "ragged_paged_attention":
            assert rec["config"] == {} and rec["n_configs"] == 0
        elif rec["config"]:
            assert rec["time_ms"] < rec["default_time_ms"]
    # the round trip: the tuned entry now moves the wrapper's plan
    tuning.set_db(out)
    r = next(r for r in rows if r["kernel"] == "softmax" and r["config"])
    rows_, cols = r["shape"]
    assert ksoftmax.launch_plan(rows_, cols, 0, 0)[:2] == (
        r["config"]["route"], r["config"]["cluster"])
    assert any(cfg is None for _, cfg in timed)


def test_measure_is_infeasible_not_raising_off_the_card():
    fam = space.SPACES["softmax"]
    case = fam.build((16, 4096), "float32", torch.device("cpu"))
    with pytest.raises(measure.Infeasible):
        measure.measure_config(fam, case, (16, 4096), "float32",
                               {"route": "staged", "cluster": 1}, "cpu")
    bad = space.Case(lambda: case.want + 1.0, case.want, 1e-6, 0.0)
    with pytest.raises(measure.Infeasible, match="tolerance"):
        measure.measure_config(fam, bad, (16, 4096), "float32", None, "cpu")


def test_paddle_tune_exit_codes(capsys, tmp_path):
    assert cli.main(["tune", "--kernel=bogus"]) == 2
    assert "unknown kernel" in capsys.readouterr().err
    assert cli.main(["tune", "stray"]) == 2
    capsys.readouterr()
    if not torch.cuda.is_available():
        assert cli.main(["tune", "--smoke",
                         f"--output={tmp_path / 'db.json'}"]) == 1
        assert "CUDA card" in capsys.readouterr().err
        assert not os.path.exists(tmp_path / "db.json")
