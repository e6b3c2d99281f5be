"""The port's AOT serving artifacts on the CPU (``paddle_tpu_torch/aot``)
against the JAX package's (``paddle_tpu/aot``), on the MLP of
``paddle_tpu/aot/compile_cli.py``'s smoke (x[6] -> fc 16 relu -> fc 4
softmax): the manifest's keys and names equal the JAX package's export of
the same model directory; an artifact-booted server answers byte for byte
as a plan-booted one, from loaded plans only; every rejection reason is
counted in ``aot_load_total{result}`` and the replies stay equal; the
kernel libraries' loader takes the artifact's copy only under the running
sources' hash; ``/health``'s ``aot`` block has the reference's keys.

The reference's own tests that fail here (donation in a fresh process,
the cache counters by source, fingerprint drift) and the two that depend
on the host are not used as oracles.
"""

import hashlib
import json
import os
import urllib.request

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import aot as jax_aot
from paddle_tpu_torch import aot, cli
from paddle_tpu_torch.aot.artifact import ArtifactStore
from paddle_tpu_torch.kernels import _build, tuning
from paddle_tpu_torch.kernels.tuning.db import TuningDB
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.serving import InferenceServer, ModelBundle, Replica

CPU = pt.CPUPlace()
BODIES = [{"x": np.linspace(-1.0, 1.0, 6 * n).reshape(n, 6).tolist()}
          for n in (1, 3, 4)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    tuning.disable()
    yield
    aot.detach()
    tuning.set_db(None)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The MLP exported by the JAX package (the port reads it)."""
    d = str(tmp_path_factory.mktemp("aot_model") / "model")
    fluid.framework.reset_default_programs()
    x = fluid.layers.data(name="x", shape=[6], dtype="float32")
    h = fluid.layers.fc(input=x, size=16, act="relu")
    pred = fluid.layers.fc(input=h, size=4, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    fluid.io.save_inference_model(d, ["x"], [pred], exe)
    return d


@pytest.fixture(scope="module")
def plan_replies(model_dir):
    """The plan-booted server's reply bytes to BODIES."""
    srv = InferenceServer(model_dir, max_batch=4, warmup=True, place=CPU)
    try:
        return [_post(srv, b) for b in BODIES]
    finally:
        srv.stop()


def _post(srv, payload):
    req = urllib.request.Request(
        f"http://{srv.address}/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()


def _export(model_dir, tmp_path, **kw):
    art = str(tmp_path / "artifacts")
    aot.export_model(model_dir, art, place=CPU, **kw)
    return art


def _manifest(art):
    with open(os.path.join(art, aot.MANIFEST_NAME)) as f:
        return json.load(f)


def _edit_manifest(art, mutate):
    doc = _manifest(art)
    mutate(doc)
    with open(os.path.join(art, aot.MANIFEST_NAME), "w") as f:
        json.dump(doc, f)


def _serve(model_dir, art, plan_replies, max_batch=4):
    """Serve from ``art``; the replies must equal the plan-booted ones.
    Returns (the store's results, the boot source, /health's aot)."""
    srv = InferenceServer(model_dir, max_batch=max_batch, warmup=True,
                          place=CPU, artifacts=art)
    try:
        got = [_post(srv, b) for b in BODIES]
        with urllib.request.urlopen(f"http://{srv.address}/health",
                                    timeout=60) as r:
            health = json.loads(r.read())
        results = dict(srv._artifact_store.results)
        boot = srv._pool.boot_source()
    finally:
        srv.stop()
    assert got == plan_replies
    assert aot.active_store() is None
    return results, boot, health["aot"]


# ---------------------------------------------------------------------------
# the manifest against the JAX package's
# ---------------------------------------------------------------------------


def test_manifest_matches_the_reference_export(model_dir, tmp_path):
    art = _export(model_dir, tmp_path)
    jart = str(tmp_path / "jax_artifacts")
    jax_aot.export_model(model_dir, jart, max_batch=8)
    mine, ref = _manifest(art), _manifest(jart)
    assert mine["schema"] == aot.SCHEMA != ref["schema"]
    assert mine["buckets"] == ref["buckets"] == [1, 2, 4, 8]
    # the port ships an empty tuning DB, the JAX package a CPU-tuned one
    assert mine["tuning_db"] == "empty" != ref["tuning_db"]

    def names(doc):
        return sorted((e["program_fp"], tuple(e["fetch_names"]),
                       tuple(e["state_names"]), tuple(e["donated_names"]),
                       tuple(e["held_names"]), tuple(e["written_names"]))
                      for e in doc["entries"])

    assert len(mine["entries"]) == len(ref["entries"]) == 4
    assert names(mine) == names(ref)
    # the feed signatures name the same shapes (dtype spelled by torch)
    for e in mine["entries"]:
        (name, shape, dtype), = json.loads(e["feed_sig"])
        assert name == "x" and shape[1:] == [6] and dtype == "torch.float32"
    assert {e["program_fp"] for e in mine["entries"]} == {
        ModelBundle(model_dir).program.fingerprint()}
    assert mine["kernels"] == {} and mine["env"]["platform"] == "cpu"


def test_executor_counts_aot_plans(model_dir, tmp_path):
    art = _export(model_dir, tmp_path, max_batch=2)
    store = ArtifactStore(art, place=CPU)
    bundle = ModelBundle(model_dir)
    label = bundle.program.fingerprint()[:12]
    miss = metrics.counter("executor_compile_cache_miss_total")
    hit = metrics.counter("executor_compile_cache_hit_total")
    m0, h0 = miss.value(program=label, source="aot"), hit.value(
        program=label, source="aot")
    rep = Replica(bundle, 0, CPU, store=store)
    ref = Replica(bundle, 1, CPU)
    x = np.ones((2, 6), np.float32)
    for _ in range(2):
        assert np.array_equal(rep.run({"x": x})[0], ref.run({"x": x})[0])
    assert rep.exe.compile_counts == {"plan": 0, "aot": 1}
    assert ref.exe.compile_counts == {"plan": 1, "aot": 0}
    assert miss.value(program=label, source="aot") == m0 + 1
    assert hit.value(program=label, source="aot") == h0 + 1
    assert store.results == {"loaded": 1}


def test_a_flag_turned_after_the_store_opens_is_rejected(model_dir,
                                                         tmp_path):
    """``trace_ops`` turned on after the store opened: the next plan miss
    is refused as ``rejected_flags`` and the plan built here keeps the
    flag's eager reason (host ranges do not replay from a graph)."""
    from paddle_tpu_torch.flags import FLAGS

    art = _export(model_dir, tmp_path, max_batch=2)
    store = ArtifactStore(art, place=CPU)
    assert store.poisoned is None
    bundle = ModelBundle(model_dir)
    rep = Replica(bundle, 0, CPU, store=store)
    ref = Replica(bundle, 1, CPU)
    x = np.ones((2, 6), np.float32)
    assert np.array_equal(rep.run({"x": x})[0], ref.run({"x": x})[0])
    before = FLAGS.get("trace_ops")
    FLAGS.set("trace_ops", True)
    try:
        assert np.array_equal(rep.run({"x": x})[0], ref.run({"x": x})[0])
    finally:
        FLAGS.set("trace_ops", before)
    assert store.results == {"loaded": 1, "rejected_flags": 1}
    assert rep.exe.compile_counts == {"plan": 1, "aot": 1}
    traced = [p for p in rep.exe._cache.values() if p.source == "plan"]
    assert len(traced) == 1
    assert traced[0].eager_reasons[0][0] == "FLAGS.trace_ops"


# ---------------------------------------------------------------------------
# an artifact-booted server
# ---------------------------------------------------------------------------


def test_artifact_boot_answers_byte_for_byte(model_dir, tmp_path,
                                             plan_replies):
    art = _export(model_dir, tmp_path, max_batch=4)
    results, boot, info = _serve(model_dir, art, plan_replies)
    assert boot == "aot"
    assert results == {"loaded": 3}
    assert info["boot"] == "aot" and info["poisoned"] is None
    assert info["entries"] == 3 and info["results"] == results


def test_health_aot_keys_equal_the_reference(model_dir, tmp_path,
                                             plan_replies):
    from paddle_tpu.serving import InferenceServer as JaxServer

    art = _export(model_dir, tmp_path, max_batch=4)
    _, _, info = _serve(model_dir, art, plan_replies)
    jart = str(tmp_path / "jax_artifacts")
    jax_aot.export_model(model_dir, jart, max_batch=2)
    jsrv = JaxServer(model_dir, max_batch=2, warmup=True, artifacts=jart)
    try:
        jinfo = jsrv.aot_info()
    finally:
        jsrv.stop()
    assert set(info) == set(jinfo)
    assert set(info["results"]) == {"loaded"}


def _tune_db():
    db = TuningDB()
    db.put("softmax", (8, 1000), "float32", tuning.current_device_kind(),
           {"config": {"route": "staged", "cluster": 1}})
    return db


def _truncate(art):
    for name in os.listdir(os.path.join(art, "plans")):
        path = os.path.join(art, "plans", name)
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[:len(blob) // 2])


def _bitflip(art):
    for name in os.listdir(os.path.join(art, "plans")):
        path = os.path.join(art, "plans", name)
        with open(path, "rb") as f:
            blob = bytearray(f.read())
        blob[len(blob) // 2] ^= 0x01
        with open(path, "wb") as f:
            f.write(bytes(blob))


def _corrupt_manifest(art):
    with open(os.path.join(art, aot.MANIFEST_NAME), "w") as f:
        f.write("{ not json")


def _entries(key, value):
    def mutate(doc):
        for e in doc["entries"]:
            e[key] = value(e)
    return lambda art: _edit_manifest(art, mutate)


def _doc(path, value):
    def mutate(doc):
        d = doc
        for k in path[:-1]:
            d = d[k]
        d[path[-1]] = value
    return lambda art: _edit_manifest(art, mutate)


#: reason -> (how the artifact is spoiled, whether a tuned DB is in place
#: when the store opens)
_REJECTIONS = {
    "schema": (_doc(("schema",), "paddle_tpu_torch.aot.v999"), False),
    "version": (_doc(("env", "torch"), "0.0.1"), False),
    "device": (_doc(("env", "device_kind"), "NVIDIA H100 80GB HBM3"), False),
    "tuning_db": (lambda art: None, True),
    "flags": (_doc(("flags", "trace_ops"), True), False),
    "fingerprint": (_entries("program_fp", lambda e: "0" * 40), False),
    "truncated": (_truncate, False),
    "bitflipped": (_bitflip, False),
    "corrupt_manifest": (_corrupt_manifest, False),
    "donation_drift": (_entries("donated_names",
                                lambda e: e["state_names"][:1]), False),
}
_RESULT = {"truncated": "corrupt", "bitflipped": "corrupt",
           "corrupt_manifest": "corrupt"}


@pytest.mark.parametrize("reason", sorted(_REJECTIONS))
def test_each_rejection_is_counted_and_replies_stay_equal(
        reason, model_dir, tmp_path, plan_replies):
    art = _export(model_dir, tmp_path, max_batch=4)
    spoil, tuned = _REJECTIONS[reason]
    spoil(art)
    result = "rejected_" + _RESULT.get(reason, reason)
    ctr = metrics.counter("aot_load_total")
    before = ctr.value(result=result)
    if tuned:
        tuning.set_db(_tune_db())
    results, boot, info = _serve(model_dir, art, plan_replies)
    assert results == {result: 3}, results
    assert ctr.value(result=result) == before + 3
    assert boot == "plan" and info["results"] == results
    if reason in ("schema", "version", "device", "tuning_db", "flags",
                  "corrupt_manifest"):
        assert info["poisoned"] == result[len("rejected_"):]


def test_a_wider_ladder_is_rejected_per_bucket(model_dir, tmp_path,
                                               plan_replies):
    art = _export(model_dir, tmp_path, buckets=[1, 2])
    results, boot, _ = _serve(model_dir, art, plan_replies)
    assert results == {"loaded": 2, "rejected_bucket": 1}
    assert boot == "mixed"


def test_kernel_libraries_load_only_under_the_running_hash(tmp_path):
    """The loader's choice on the CPU (no library is loaded): a library
    whose file name carries another source hash is refused, a bit-flipped
    one too, a matching one is taken; a poisoned store supplies none."""
    art = str(tmp_path / "art")
    want = os.path.basename(_build.library_path("softmax"))
    os.makedirs(os.path.join(art, "kernels"))
    for name in (want, "libsoftmax-0000000000000000.so"):
        with open(os.path.join(art, "kernels", name), "wb") as f:
            f.write(b"\x7fELF stand-in")
    sha = hashlib.sha256(b"\x7fELF stand-in").hexdigest()
    doc = {"schema": aot.SCHEMA, "entries": [],
           "env": aot.artifact.environment_fingerprint(CPU),
           "tuning_db": "empty",
           "flags": aot.artifact.flags_fingerprint(),
           "kernels": {"softmax": {"file": "kernels/libsoftmax-0000000000000000.so",
                                   "sha256": sha, "nbytes": 13}}}

    def store():
        with open(os.path.join(art, aot.MANIFEST_NAME), "w") as f:
            json.dump(doc, f)
        return aot.attach(ArtifactStore(art, place=CPU))

    s = store()
    assert _build._from_artifact("softmax",
                                 _build.library_path("softmax")) is None
    assert s.results == {"rejected_kernels": 1}
    assert _build._from_artifact("matmul",
                                 _build.library_path("matmul")) is None
    assert s.results == {"rejected_kernels": 2}
    doc["kernels"]["softmax"] = {"file": f"kernels/{want}", "sha256": "0" * 64,
                                 "nbytes": 13}
    s = store()
    assert s.kernel_path("softmax", want) is None
    assert s.results == {"rejected_corrupt": 1}
    doc["kernels"]["softmax"]["sha256"] = sha
    s = store()
    assert _build._from_artifact("softmax", _build.library_path(
        "softmax")) == os.path.join(art, "kernels", want)
    assert s.results == {"kernel_loaded": 1}
    doc["schema"] = "other"
    s = store()
    assert s.kernel_path("softmax", want) is None
    assert s.results == {"rejected_schema": 1}
    aot.detach()
    assert _build._from_artifact("softmax",
                                 _build.library_path("softmax")) is None


def test_paddle_compile_exports_and_refuses_usage(model_dir, tmp_path,
                                                  capsys):
    out = str(tmp_path / "art")
    assert cli.main(["compile", f"--model_dir={model_dir}", f"--out={out}",
                     "--max_batch=2", "--cpu"]) == 0
    text = capsys.readouterr().out
    assert "exported 2 plan(s)" in text and "0 kernel libraries" in text
    assert _manifest(out)["buckets"] == [1, 2]
    assert cli.main(["compile", f"--out={out}"]) == 2
    assert cli.main(["compile", f"--model_dir={model_dir}",
                     f"--out={out}", "--max_batch=x", "--cpu"]) == 2
    assert "usage" in capsys.readouterr().err
