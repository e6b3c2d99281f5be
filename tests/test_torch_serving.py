"""The serving slice of the port as a whole, on the CPU: ResNet exports
written by paddle_tpu served by the port's ModelBundle/Replica (and the
other way round), the port's batching pieces, its HTTP InferenceServer
and launcher, and the rule that the port never loads jax or paddle_tpu.

Tolerances: probabilities rtol 1e-4 / atol 1e-5 and the same argmax
(float32 end to end; conv and matmul sums in another order than XLA's
over 50 layers)."""

import ast
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.serving import batching as jax_batching
from paddle_tpu_torch.serving import InferenceServer, ModelBundle, Replica
from paddle_tpu_torch.serving.batching import (BatchSpec, PendingRequest,
                                               RequestQueue, bucket_ladder,
                                               coalesce, next_bucket, scatter)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBS = dict(rtol=1e-4, atol=1e-5)


def calibrated_bn_stats(program, state, feed, seed):
    """Seeded BN running statistics for a randomly initialised ResNet
    (``chip_smoke.calibrate_bn``, on the CPU): {name: float32 array}."""
    scope = pt.Scope()
    scope.load_numpy(state, "cpu")
    return chip_smoke.calibrate_bn(program, scope, feed, torch.device("cpu"),
                                   seed)


def _export_from_paddle_tpu(tmp_path, model, rng):
    """A save_inference_model export of a randomly initialised ResNet at
    3x32x32, written by paddle_tpu; returns (dir, feed batch)."""
    from paddle_tpu.models import resnet

    img = fluid.layers.data(name="img", shape=[3, 32, 32])
    if model == "cifar8":
        pred = resnet.resnet_cifar10(img, depth=8)
    else:
        pred = resnet.resnet_imagenet(img, depth=50)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    scope = fluid.global_scope()
    calib = rng.randn(16, 3, 32, 32).astype(np.float32)
    x = rng.randn(4, 3, 32, 32).astype(np.float32)
    test = fluid.default_main_program().clone(for_test=True)
    state = {n: np.asarray(v) for n, v in scope.values.items()}
    for name, arr in calibrated_bn_stats(
            pt.Program.from_dict(test.to_dict()), state, {"img": calib},
            seed=5).items():
        scope.set(name, jnp.asarray(arr))
    d = str(tmp_path / model)
    fluid.io.save_inference_model(d, ["img"], [pred], exe)
    return d, x


@pytest.mark.parametrize("model", ["cifar8", "imagenet50"])
def test_paddle_tpu_export_served_by_port(tmp_path, rng, model):
    d, x = _export_from_paddle_tpu(tmp_path, model, rng)
    program, feeds, fetches = fluid.io.load_inference_model(
        d, fluid.Executor(fluid.CPUPlace()))
    (want,) = fluid.Executor(fluid.CPUPlace()).run(
        program, feed={"img": x}, fetch_list=fetches)

    bundle = ModelBundle(d)
    assert bundle.feed_names == ["img"] and bundle.fetch_names == fetches
    (got,) = Replica(bundle, 0, pt.CPUPlace()).run({"img": x})
    assert got.shape == want.shape == (4, 1000 if model != "cifar8" else 10)
    assert float(np.max(want)) < 0.9  # the softmax is not saturated
    np.testing.assert_allclose(got, want, **PROBS)
    np.testing.assert_array_equal(got.argmax(1), np.asarray(want).argmax(1))


def test_port_export_loads_in_paddle_tpu(tmp_path, rng):
    from paddle_tpu_torch.models import resnet_cifar10

    pt.framework.reset_default_programs()
    img = pt.layers.data(name="img", shape=[3, 32, 32])
    pred = resnet_cifar10(img, depth=8)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    calib = rng.randn(16, 3, 32, 32).astype(np.float32)
    x = rng.randn(3, 3, 32, 32).astype(np.float32)
    test = pt.default_main_program().clone(for_test=True)
    state = {n: v.numpy() for n, v in scope.values.items()}
    scope.load_numpy(calibrated_bn_stats(test, state, {"img": calib},
                                         seed=6), "cpu")
    d = str(tmp_path / "port_export")
    pt.io.save_inference_model(d, ["img"], [pred], exe, scope=scope)
    (want,) = exe.run(test, feed={"img": x}, fetch_list=[pred], scope=scope)

    program, feeds, fetches = fluid.io.load_inference_model(
        d, fluid.Executor(fluid.CPUPlace()))
    assert feeds == ["img"] and fetches == [pred.name]
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        program, feed={"img": x}, fetch_list=fetches)
    np.testing.assert_allclose(np.asarray(got), want, **PROBS)
    # and the port reads its own export back the same way
    port_prog, _, port_fetches = pt.io.load_inference_model(d, exe,
                                                            pt.Scope())
    assert port_prog.to_dict() == program.to_dict()


# ---------------------------------------------------------------------------
# batching pieces
# ---------------------------------------------------------------------------


def test_bucket_ladder_matches_paddle_tpu():
    for n in range(0, 70):
        assert next_bucket(n) == jax_batching.next_bucket(n)
    for cap in (1, 2, 3, 8, 32, 33):
        assert bucket_ladder(cap) == jax_batching.bucket_ladder(cap)


def test_coalesce_pads_with_last_row_and_scatter_slices_back():
    spec = BatchSpec(True, "ok", ["x"], {"x": (2,)}, {"x": np.float32})
    reqs = [PendingRequest({"x": np.full((n, 2), i, np.float32)}, rows=n,
                           batchable=True) for i, n in enumerate((1, 3, 1))]
    feeds, rows, bucket = coalesce(reqs, spec)
    assert (rows, bucket) == (5, 8)
    assert feeds["x"][:, 0].tolist() == [0, 1, 1, 1, 2, 2, 2, 2]
    scatter(reqs, [feeds["x"] * 10], bucket)
    assert [r.outputs[0][:, 0].tolist() for r in reqs] == [
        [0.0], [10.0, 10.0, 10.0], [20.0]]
    with pytest.raises(RuntimeError, match="batch-aligned"):
        scatter(reqs, [np.zeros((3, 2))], bucket)


def test_request_queue_groups_rows_and_expires_deadlines():
    q = RequestQueue(max_batch=4)
    big = PendingRequest({}, rows=3, batchable=True)
    solo = PendingRequest({}, rows=1, batchable=False)
    small = [PendingRequest({}, rows=1, batchable=True) for _ in range(2)]
    late = PendingRequest({}, rows=1, batchable=True,
                          deadline=time.monotonic() - 1.0)
    for r in [late, big, solo] + small:
        q.submit(r)
    assert q.take() == [big, small[0]]       # arrival order, <= 4 rows
    assert late.done and isinstance(late.error, TimeoutError)
    assert q.take() == [solo]                # unbatchable runs alone
    assert q.take() == [small[1]]
    waiter = PendingRequest({}, rows=1, batchable=True)
    q.submit(waiter)
    q.close()
    assert q.take() is None and isinstance(waiter.error, RuntimeError)


def test_request_queue_lingers_to_fill_a_bucket():
    q = RequestQueue(max_batch=4, batch_timeout=5.0)
    first = PendingRequest({}, rows=1, batchable=True)
    q.submit(first)
    got = []
    t = threading.Thread(target=lambda: got.append(q.take()))
    t.start()
    time.sleep(0.05)
    rest = [PendingRequest({}, rows=1, batchable=True) for _ in range(3)]
    for r in rest:
        q.submit(r)
    t.join(timeout=10)
    assert not t.is_alive() and got == [[first] + rest]


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------


def _small_export(tmp_path):
    """A tiny fc + softmax export written by the port."""
    pt.framework.reset_default_programs()
    x = pt.layers.data(name="x", shape=[6])
    pred = pt.layers.fc(x, size=3, act="softmax")
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(pt.default_startup_program(), scope=scope)
    d = str(tmp_path / "m")
    pt.io.save_inference_model(d, ["x"], [pred], exe, scope=scope)
    return d, exe, scope, pred


def _post(base, payload, timeout=60):
    req = urllib.request.Request(f"{base}/predict",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _http_error(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]
    raise AssertionError("expected an HTTP error")


def test_inference_server_serves_and_rejects(tmp_path, rng):
    d, exe, scope, pred = _small_export(tmp_path)
    xs = rng.randn(4, 6).astype(np.float32)
    (expected,) = exe.run(pt.default_main_program().clone(for_test=True),
                          feed={"x": xs}, fetch_list=[pred], scope=scope)
    srv = InferenceServer(d, place=pt.CPUPlace(), warmup=True)
    try:
        base = f"http://{srv.address}"
        with urllib.request.urlopen(f"{base}/health", timeout=10) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["feeds"] == ["x"]
        assert h["place"] == "CPUPlace()" and h["batching"]["enabled"]
        got = np.asarray(_post(base, {"x": xs.tolist()})["outputs"][0],
                         np.float32)
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)
        code, err = _http_error(lambda: _post(base, {}))
        assert code == 400 and "missing feed" in err
        code, err = _http_error(
            lambda: _post(base, {"x": xs.tolist(), "y": [1]}))
        assert code == 400 and "unknown payload key 'y'" in err
        code, _ = _http_error(lambda: urllib.request.urlopen(
            f"{base}/nope", timeout=10))
        assert code == 404
    finally:
        srv.stop()


def test_inference_server_coalesces_concurrent_requests(tmp_path, rng):
    d, exe, scope, pred = _small_export(tmp_path)
    test = pt.default_main_program().clone(for_test=True)
    srv = InferenceServer(d, place=pt.CPUPlace(), max_batch=8,
                          batch_timeout_ms=200.0)
    batches = [rng.randn(n, 6).astype(np.float32) for n in (1, 2, 3, 2)]
    results = [None] * len(batches)
    try:
        base = f"http://{srv.address}"

        def client(i):
            results[i] = _post(base, {"x": batches[i].tolist()})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(batches))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.stop()
    for xs, res in zip(batches, results):
        (want,) = exe.run(test, feed={"x": xs}, fetch_list=[pred],
                          scope=scope)
        np.testing.assert_allclose(np.asarray(res["outputs"][0], np.float32),
                                   want, rtol=1e-5, atol=1e-6)


def test_inference_server_deadline_and_overload(tmp_path, rng):
    d, _, _, _ = _small_export(tmp_path)
    srv = InferenceServer(d, place=pt.CPUPlace())
    try:
        with pytest.raises(TimeoutError):
            srv.predict({"x": rng.randn(1, 6).tolist()},
                        deadline=time.monotonic() - 1.0)
    finally:
        srv.stop()
    srv = InferenceServer(d, place=pt.CPUPlace(), max_inflight=1)
    try:
        srv._slots.acquire()  # one request in flight
        code, err = _http_error(
            lambda: _post(f"http://{srv.address}", {"x": [[0.0] * 6]}))
        assert code == 503 and "overloaded" in err
        srv._slots.release()
    finally:
        srv.stop()


def _request(base, path, payload, tenant=None):
    """(status, parsed body) of one POST; streamed ndjson as a list."""
    headers = {"Content-Type": "application/json"}
    if tenant is not None:
        headers["X-Tenant"] = tenant
    req = urllib.request.Request(f"{base}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    lines = [json.loads(x) for x in body.splitlines() if x.strip()]
    return code, lines[0] if len(lines) == 1 else lines


def test_tenant_key_and_header_answer_as_the_reference(tmp_path, rng):
    """``/predict`` and ``/generate`` requests carrying a ``"tenant"`` key,
    an ``X-Tenant`` header or both get the reference server's status and
    body (the reference without ``--tenants`` admits every tenant):
    outputs within 1e-5, generated ids and error replies equal."""
    from paddle_tpu.decode.engine import GenerationEngine as JaxEngine
    from paddle_tpu.decode.model import TinyDecoderLM as JaxLM
    from paddle_tpu.serving import InferenceServer as JaxServer
    from paddle_tpu_torch.decode.engine import GenerationEngine
    from paddle_tpu_torch.decode.model import TinyDecoderLM

    d, _, _, _ = _small_export(tmp_path)
    jm = JaxLM(seed=3, num_pages=32)
    pm = TinyDecoderLM(vocab=jm.vocab, d_model=jm.d, num_heads=jm.heads,
                       num_layers=jm.layers, max_len=jm.max_len,
                       num_pages=jm.allocator.num_pages,
                       page_size=jm.page_size,
                       pages_per_seq=jm.pages_per_seq, place=pt.CPUPlace(),
                       params=jax.tree_util.tree_map(np.asarray, jm.params))
    servers = [JaxServer(d, generator=JaxEngine(jm, max_slots=2,
                                                max_new_tokens=4)),
               InferenceServer(d, place=pt.CPUPlace(),
                               generator=GenerationEngine(
                                   pm, max_slots=2, max_new_tokens=4))]
    xs = rng.randn(3, 6).astype(np.float32).tolist()
    src = [2, 3, 4, 5, 6]
    requests = [
        ("/predict", {"x": xs, "tenant": "A"}, "B"),
        ("/predict", {"x": xs}, "B"),
        ("/predict", {"x": xs, "tenant": ""}, None),
        ("/predict", {"x": xs, "tenant": "A", "y": [1]}, "B"),
        ("/generate", {"src": src, "stream": False, "tenant": "A"}, "B"),
        ("/generate", {"src": src, "tenant": "B"}, None),
        ("/generate", {"src": src, "stream": False}, "A"),
        ("/generate", {"src": [1], "tenant": "A", "nucleus": 2}, "A"),
    ]
    try:
        for path, payload, tenant in requests:
            (jcode, want), (pcode, got) = (
                _request(f"http://{s.address}", path, dict(payload), tenant)
                for s in servers)
            assert pcode == jcode, (path, payload, got, want)
            if path == "/predict" and jcode == 200:
                np.testing.assert_allclose(got["outputs"][0],
                                           want["outputs"][0],
                                           rtol=1e-5, atol=1e-5)
            elif path == "/generate":
                assert got == want, (payload, got, want)
        assert [c for c, _ in (_request(f"http://{servers[1].address}", p,
                                        dict(b), t)
                               for p, b, t in requests)] == [
            200, 200, 200, 400, 200, 200, 200, 400]
    finally:
        for s in servers:
            s.stop()


def test_entry_points_default_to_the_card(tmp_path):
    d, _, _, _ = _small_export(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a CUDA device")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pt.Executor()
    with pytest.raises(RuntimeError, match="CPUPlace"):
        InferenceServer(d)


def test_launcher_serves_on_the_cpu(tmp_path, rng):
    d, _, _, _ = _small_export(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving",
         f"--model_dir={d}", "--port=0", "--cpu", "--warmup"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        base = line.split()[-1]
        out = _post(base, {"x": rng.randn(2, 6).tolist()})
        assert np.asarray(out["outputs"][0]).shape == (2, 3)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_metrics_stats_and_health_keys(tmp_path, rng):
    """GET /metrics is Prometheus 0.0.4 text with the reference's content
    type whose counts agree with the requests served; GET /stats is the
    registry's snapshot; /health carries the reference's keys (and the
    port's ``place``)."""
    from paddle_tpu.serving import InferenceServer as JaxServer
    from paddle_tpu_torch import observability as obs

    d, _, _, _ = _small_export(tmp_path)
    obs.reset()
    srv = InferenceServer(d, place=pt.CPUPlace(), warmup=True)
    ref = JaxServer(d)
    try:
        base = f"http://{srv.address}"
        for n in (1, 3):
            _post(base, {"x": rng.randn(n, 6).tolist()})
        code, _ = _http_error(lambda: _post(base, {}))
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            ctype = r.headers["Content-Type"]
            samples = chip_smoke.parse_prometheus(r.read().decode())
        with urllib.request.urlopen(f"http://{ref.address}/metrics",
                                    timeout=10) as r:
            assert r.headers["Content-Type"] == ctype
        assert ctype == "text/plain; version=0.0.4; charset=utf-8"
        total = chip_smoke.prom_total
        assert total(samples, "serving_responses_total", code="200") == 2
        assert total(samples, "serving_responses_total", code="400") == 1
        assert total(samples, "serving_request_seconds_count",
                     endpoint="/predict") == 3
        assert total(samples, "serving_inflight_requests") == 0
        ladder = len(bucket_ladder(8))
        # the ladder warmed, then buckets 1 and 4 hit
        assert total(samples, "executor_compile_cache_miss_total",
                     source="plan") == ladder
        assert total(samples, "executor_compile_cache_hit_total",
                     source="plan") == 2
        assert total(samples, "serving_batch_size_count") == 2
        assert total(samples, "serving_time_to_ready_seconds_count",
                     boot="plan") == 1
        assert total(samples, "executor_fetch_device_to_host_bytes_total") \
            == (sum(bucket_ladder(8)) + 1 + 4) * 3 * 4
        stats = json.loads(urllib.request.urlopen(f"{base}/stats",
                                                  timeout=10).read())
        snap = json.loads(json.dumps(obs.snapshot()))
        for v in snap["serving_responses_total"]["values"]:
            if v["labels"] == {"code": "200"}:
                v["value"] -= 1      # the /stats reply itself
        assert stats == snap
        health, want = (json.loads(urllib.request.urlopen(
            f"http://{a}/health", timeout=10).read())
            for a in (srv.address, ref.address))
        assert set(health) - {"place"} == set(want)
        assert health["status"] == "ok" and health["reasons"] == []
        assert health["aot"] is None and health["fetches"] == want["fetches"]
        assert set(health["self_healing"]) == set(want["self_healing"])
        assert set(health["self_healing"]["pool"]) == \
            set(want["self_healing"]["pool"])
        assert health["self_healing"]["queue"] == want["self_healing"]["queue"]
        with pytest.raises(ValueError, match="malformed labels"):
            chip_smoke.parse_prometheus("# TYPE a counter\na{b=1} 2")
        with pytest.raises(ValueError, match="not a Prometheus sample"):
            chip_smoke.parse_prometheus("# TYPE a counter\na 1 2")
        with pytest.raises(ValueError, match="undeclared"):
            chip_smoke.parse_prometheus("a 2")
    finally:
        srv.stop()
        ref.stop()


def test_artifacts_and_check_program_raise(tmp_path, rng):
    """``artifacts`` naming a directory with no manifest serves all the
    same, from plans built in process (the store is poisoned "corrupt"
    and every lookup counted); the check_program flag, which raised
    once, runs the verifier over the export at the replica's plan miss,
    which passes it."""
    from paddle_tpu_torch.flags import FLAGS

    d, _, _, _ = _small_export(tmp_path)
    srv = InferenceServer(d, place=pt.CPUPlace(), artifacts=str(tmp_path))
    try:
        out = _post(f"http://{srv.address}",
                    {"x": rng.randn(2, 6).tolist()})["outputs"][0]
        assert np.asarray(out).shape == (2, 3)
        info = srv.aot_info()
        assert info["poisoned"] == "corrupt" and info["boot"] == "plan"
        assert info["results"] == {"rejected_corrupt": 1}
    finally:
        srv.stop()
    rep = Replica(ModelBundle(d), 0, pt.CPUPlace())
    try:
        FLAGS.set("check_program", True)
        assert rep.run({"x": rng.randn(1, 6).astype(
            np.float32)})[0].shape == (1, 3)
    finally:
        FLAGS.set("check_program", False)
    assert rep.run({"x": rng.randn(1, 6).astype(np.float32)})[0].shape == \
        (1, 3)


def test_launcher_takes_the_operations_flags(tmp_path, rng):
    """The launcher passes --tenant_config (JSON), --max_attempts,
    --replica_heartbeat_ms, --dispatch_timeout and --chaos through, and
    --artifacts: a directory without a manifest starts and serves from
    plans built in process."""
    from paddle_tpu_torch.serving.__main__ import tenant_spec

    d, _, _, _ = _small_export(tmp_path)
    conf = tmp_path / "tenants.json"
    conf.write_text(json.dumps({"A": {"rate": 0.05, "burst": 1},
                                "*": {"weight": 2}}))
    lines = tmp_path / "tenants.txt"
    lines.write_text("# tenants\nA:0.05:1\nB:::3\n")
    ns = type("Args", (), {"tenants": "C:1", "tenant_config": None})
    assert tenant_spec(ns) == "C:1"
    ns.tenant_config = str(lines)
    assert tenant_spec(ns) == "A:0.05:1,B:::3"
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving",
         f"--model_dir={d}", "--port=0", "--cpu", "--warmup",
         "--replicas=2", f"--tenant_config={conf}", "--max_attempts=2",
         "--replica_heartbeat_ms=50", "--dispatch_timeout=7",
         "--chaos=die@1"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        base = line.split()[-1]
        x = rng.randn(2, 6).tolist()
        # the first live dispatch dies: requeued, answered all the same
        assert _request(base, "/predict", {"x": x}, "A")[0] == 200
        code, body = _request(base, "/predict", {"x": x, "tenant": "A"})
        assert (code, body["reason"]) == (429, "tenant_over_quota")
        deadline = time.monotonic() + 30
        while True:
            with urllib.request.urlopen(f"{base}/health", timeout=10) as r:
                h = json.loads(r.read())
            if h["self_healing"]["pool"]["restarts"] >= 1 or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
        pool = h["self_healing"]["pool"]
        assert (pool["max_attempts"], pool["heartbeat_s"],
                pool["dispatch_timeout_s"], pool["restarts"]) == (
            2, 0.05, 7.0, 1)
        assert h["self_healing"]["tenants"]["A"]["burst"] == 1.0
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            samples = chip_smoke.parse_prometheus(r.read().decode())
        assert chip_smoke.prom_total(samples, "serving_replica_deaths_total",
                                     cause="injected") == 1
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving",
         f"--model_dir={d}", "--port=0", "--cpu", f"--artifacts={tmp_path}"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        base = line.split()[-1]
        assert _request(base, "/predict", {"x": rng.randn(1, 6).tolist()})[
            0] == 200
        with urllib.request.urlopen(f"{base}/health", timeout=10) as r:
            aot = json.loads(r.read())["aot"]
        assert (aot["poisoned"], aot["boot"]) == ("corrupt", "plan")
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert "unreadable manifest" in proc.stderr.read()


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

_PROBE = r"""
import sys
import numpy as np
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import resnet_cifar10
img = pt.layers.data(name="img", shape=[3, 8, 8])
pred = resnet_cifar10(img, depth=8)
exe = pt.Executor(pt.CPUPlace())
exe.run(pt.default_startup_program())
(out,) = exe.run(pt.default_main_program().clone(for_test=True),
                 feed={"img": np.zeros((2, 3, 8, 8), np.float32)},
                 fetch_list=[pred])
assert out.shape == (2, 10)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "paddle_tpu" or m.startswith("paddle_tpu."))
print("LOADED", bad)
"""


def test_port_never_loads_jax_or_paddle_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_port_sources_import_no_jax_or_paddle_tpu():
    pkg = os.path.join(REPO, "paddle_tpu_torch")
    offenders = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                else:
                    continue
                for n in names:
                    top = n.split(".")[0]
                    if top in ("jax", "jaxlib", "paddle_tpu"):
                        offenders.append((os.path.relpath(path, REPO), n))
    assert offenders == []
