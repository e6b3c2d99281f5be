"""The port's serving operations on the CPU, each case held against the
JAX package's server under the same scenario: tenant quotas (token
buckets with an injected clock, 429 over HTTP, weighted-fair dequeue in
the reference's take order, single-tenant FIFO), supervised replicas
(an injected death requeues its batch onto a respawned replica, a
poison request is quarantined after ``max_attempts``, a hang is swept by
the lease, a request's own error keeps the replica), ``FaultInjector``
specs, ``--chaos`` armed after warmup, and shedding the low-weight
tenants first with ``/health`` degraded for the same reasons.

Both servers load the same small fc + softmax export written by the JAX
package.  Status codes, reasons, counters and take orders are compared
exactly; replies to rtol 1e-5 / atol 1e-6 (float32).  Every server stops
in a ``finally``, every wait is bounded, and hangs and leases are
fractions of a second."""

import dataclasses
import json
import random
import threading
import time
import types
import urllib.error
import urllib.request

import jax  # noqa: F401  (keep jax on the CPU before paddle_tpu loads)
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import serving as jax_serving
from paddle_tpu.distributed import retry as jax_retry
from paddle_tpu.serving import batching as jax_batching
from paddle_tpu.serving import replica as jax_replica
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving as pt_serving
from paddle_tpu_torch.distributed import retry as pt_retry
from paddle_tpu_torch.serving import batching as pt_batching
from paddle_tpu_torch.serving import replica as pt_replica
from test_torch_demos import one_torch_thread  # noqa: F401

KITS = {
    "port": types.SimpleNamespace(serving=pt_serving, batching=pt_batching,
                                  replica=pt_replica, retry=pt_retry,
                                  kw={"place": pt.CPUPlace()}),
    "reference": types.SimpleNamespace(serving=jax_serving,
                                       batching=jax_batching,
                                       replica=jax_replica, retry=jax_retry,
                                       kw={}),
}
BODY = {"x": [[1.0, 2.0, 3.0, 4.0]]}


@pytest.fixture(autouse=True)
def fresh_port_telemetry():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture
def model_dir(tmp_path):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.fc(input=x, size=2, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    fluid.io.save_inference_model(str(tmp_path / "model"), ["x"], [y], exe)
    return str(tmp_path / "model")


def _post(addr, payload, headers=None, timeout=30, path="/predict"):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(
        f"http://{addr}{path}", data=json.dumps(payload).encode(),
        headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_json(addr, path):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=30) as r:
        return json.loads(r.read())


def _wait_for(cond, timeout=15.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _on_both(scenario, *args):
    """``scenario(kit, *args)`` on the port and on the reference."""
    return {name: scenario(kit, *args) for name, kit in KITS.items()}


def _serve(kit, model_dir, **kw):
    return kit.serving.InferenceServer(model_dir, **kit.kw, **kw)


def _join_zombies(srv, timeout=10.0):
    """Wait (bounded) for every dead replica's thread to end, so no
    thread outlives the test."""
    pool = srv._pool
    with pool._lock:
        threads = [t for i, t in pool._threads.items() if i in pool._dead]
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


# -- RetryPolicy.for_attempt ------------------------------------------------


def test_for_attempt_backoff_and_jitter_bounds():
    for kit in KITS.values():
        p = kit.retry.RetryPolicy(base_delay=0.1, max_delay=1.0,
                                  multiplier=2.0, jitter=0.25)
        for n in range(8):
            d = min(0.1 * 2.0 ** n, 1.0)
            for _ in range(20):
                assert d * 0.75 - 1e-9 <= p.for_attempt(n) <= d * 1.25 + 1e-9
        exact = p.with_(jitter=0.0)
        assert exact.for_attempt(0) == pytest.approx(0.1)
        assert exact.for_attempt(3) == pytest.approx(0.8)
        assert exact.for_attempt(10) == pytest.approx(1.0)   # capped
        assert list(exact.delays()) == [exact.for_attempt(i) for i in
                                        range(exact.max_attempts - 1)]
    # the same draws from the same seed
    port, ref = (k.retry.RetryPolicy(jitter=0.5) for k in KITS.values())
    for n in range(6):
        assert port.for_attempt(n, random.Random(n)) == \
            ref.for_attempt(n, random.Random(n))
    assert list(port.delays(random.Random(3))) == \
        list(ref.delays(random.Random(3)))
    assert dataclasses.asdict(pt_replica.RESPAWN_POLICY) == \
        dataclasses.asdict(jax_replica.RESPAWN_POLICY)


def test_retry_call_counts_retries_and_exhaustion():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("down")
        return "up"

    policy = pt_retry.RetryPolicy(base_delay=0.001, jitter=0.0)
    assert pt_retry.retry_call(flaky, policy=policy, client="c",
                               op="o") == "up"
    assert pt_retry._M_RETRIES.value(client="c", op="o") == 2
    with pytest.raises(ConnectionError):
        pt_retry.retry_call(lambda: (_ for _ in ()).throw(
            ConnectionError("x")), policy=policy.with_(max_attempts=2),
            client="c", op="o")
    assert pt_retry._M_EXHAUSTED.value(client="c", op="o") == 1
    with pytest.raises(KeyError):        # not a transport error
        pt_retry.retry_call(lambda: {}["k"], policy=policy)


# -- tenant quotas ------------------------------------------------------------


def test_token_bucket_charges_and_refills_on_an_injected_clock():
    got = {}
    for name, kit in KITS.items():
        q = kit.batching.TenantQuota("x", rate=10.0, burst=2.0)
        q._last = 0.0
        trace = [q.try_take(now=t) for t in
                 (0.0, 0.0, 0.0, 0.05, 0.1, 0.1, 0.35, 0.35, 0.35, 100.0)]
        trace.append(q.available(now=1000.0))   # capped at one burst
        reg = kit.batching.TenantRegistry.parse("A:10:2:1")
        reg.admit("A")
        reg.admit("A")
        with pytest.raises(kit.batching.TenantOverQuota) as ei:
            reg.admit("A")
        assert ei.value.tenant == "A"
        for _ in range(50):       # unconfigured tenants: the "*" template
            reg.admit("anyone-else")
        got[name] = trace
    assert got["port"] == got["reference"]
    assert got["port"] == [True, True, False, False, True, False, True,
                           True, False, True, 2.0]


def test_tenant_registry_parse_matches_the_reference():
    specs = ["A:100:20:4,B:50::1,*:10:10", "A", " A:1 , ,B:-:3:2 ",
             "gold:5:4:4,bronze:1:2:1"]
    for spec in specs:
        port = pt_batching.TenantRegistry.parse(spec)
        ref = jax_batching.TenantRegistry.parse(spec)
        assert port._template == ref._template
        for t in ("A", "B", "gold", "bronze", "unknown"):
            p, r = port.get(t), ref.get(t)
            assert (p.rate, p.burst, p.weight) == (r.rate, r.burst, r.weight)
        assert port.max_weight() == ref.max_weight()
        assert port.info().keys() == ref.info().keys()
    for bad in (":1", "A:-1", "A:1:0.5", "A:1:2:0"):
        for kit in KITS.values():
            with pytest.raises(ValueError):
                kit.batching.TenantRegistry.parse(bad)


def _quota_scenario(kit, model_dir):
    srv = _serve(kit, model_dir, tenants="A:0.05:1")
    try:
        codes = [_post(srv.address, BODY, headers={"X-Tenant": "A"})]
        codes.append(_post(srv.address, BODY, headers={"X-Tenant": "A"}))
        codes.append(_post(srv.address, dict(BODY, tenant="A")))
        codes.append(_post(srv.address, dict(BODY, tenant="B")))
        rejected = kit.serving._M_REJECTED.value(reason="tenant_over_quota",
                                                 tenant="A")
        responses = {c: kit.serving._M_RESPONSES.value(code=c)
                     for c in ("200", "429")}
        outs = [np.asarray(d["outputs"][0]) for c, d in codes if c == 200]
        refused = [(c, d.get("reason"), d.get("tenant")) for c, d in codes
                   if c != 200]
        return [c for c, _ in codes], refused, rejected, responses, outs
    finally:
        srv.stop()


def test_tenant_over_quota_http_429_and_metric(model_dir):
    got = _on_both(_quota_scenario, model_dir)
    port, ref = got["port"], got["reference"]
    assert port[:4] == ref[:4]
    assert port[0] == [200, 429, 429, 200]
    assert port[1] == [(429, "tenant_over_quota", "A")] * 2
    assert port[2] == 2 and port[3] == {"200": 2.0, "429": 2.0}
    for a, b in zip(port[4], ref[4]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_generate_answers_429_before_any_decode():
    from paddle_tpu_torch.decode import GenerationEngine
    from paddle_tpu_torch.decode.model import TinyDecoderLM

    model = TinyDecoderLM(vocab=16, d_model=16, num_heads=2, num_layers=1,
                          num_pages=8, page_size=4, pages_per_seq=2,
                          place=pt.CPUPlace())
    srv = pt_serving.InferenceServer(
        None, generator=GenerationEngine(model, max_slots=2,
                                         max_new_tokens=3),
        tenants="A:0.05:1")
    try:
        body = {"src": [1, 2], "stream": False}
        code, doc = _post(srv.address, body, {"X-Tenant": "A"},
                          path="/generate")
        assert code == 200 and len(doc["ids"]) > 0
        steps = srv._generator.info()
        code, doc = _post(srv.address, dict(body, tenant="A"),
                          path="/generate")
        assert code == 429 and doc["reason"] == "tenant_over_quota"
        assert srv._generator.info() == steps      # nothing decoded
        assert pt_serving._M_REJECTED.value(reason="tenant_over_quota",
                                            tenant="A") == 1
        # observed after the reply is written
        assert _wait_for(
            lambda: pt_serving._M_REQ_SEC.count(endpoint="/generate") == 2)
        assert _wait_for(lambda: [e["name"] for e in
                                  obs.GLOBAL_EVENTS.events()].count(
                                      "serving.generate") == 2)
    finally:
        srv.stop()


# -- weighted-fair dequeue ----------------------------------------------------


def _fair_order(kit):
    reg = kit.batching.TenantRegistry.parse("A:::1,B:::2,C:::4")
    q = kit.batching.RequestQueue(max_batch=1, tenants=reg)
    for i in range(30):
        for tenant in ("A", "B", "C"):
            q.submit(kit.batching.PendingRequest(
                {"x": i}, rows=1, batchable=True, tenant=tenant))
    order = [(r.tenant, r.feeds["x"]) for _ in range(21)
             for r in q.take()]
    vclock = q._vclock
    late = kit.batching.PendingRequest({"x": 99}, rows=1, batchable=True,
                                       tenant="D")
    q.submit(late)
    # rows-weighted: a 3-row request of B costs 1.5 of virtual time
    q2 = kit.batching.RequestQueue(max_batch=4, tenants=reg)
    for tenant, rows in (("A", 1), ("B", 3), ("C", 2), ("A", 2), ("C", 1)):
        q2.submit(kit.batching.PendingRequest({}, rows=rows, batchable=True,
                                              tenant=tenant))
    groups = [[(r.tenant, r.rows) for r in q2.take()] for _ in range(3)]
    return order, late._vft >= vclock, groups, q.depth()


def test_weighted_fair_dequeue_in_the_reference_order():
    got = _on_both(_fair_order)
    assert got["port"] == got["reference"]
    order, late_ok, _, depth = got["port"]
    counts = {t: sum(1 for o, _ in order if o == t) for t in "ABC"}
    assert counts == {"A": 3, "B": 6, "C": 12}     # the weights, 1:2:4
    assert late_ok and depth == 90 - 21 + 1
    # FIFO within a tenant
    for t in "ABC":
        seq = [i for o, i in order if o == t]
        assert seq == sorted(seq)


def test_single_tenant_is_plain_fifo():
    for kit in KITS.values():
        q = kit.batching.RequestQueue(max_batch=1)
        reqs = [kit.batching.PendingRequest({"i": i}, rows=1,
                                            batchable=True)
                for i in range(10)]
        for r in reqs:
            q.submit(r)
        assert [q.take()[0] for _ in range(10)] == reqs
        assert all(r.attempts == 1 for r in reqs)


# -- supervised replicas -----------------------------------------------------


def _death_scenario(kit, model_dir):
    fault = kit.replica.FaultInjector("die", nth=1)
    srv = _serve(kit, model_dir, replicas=2, replica_heartbeat_ms=50,
                 chaos=fault)
    try:
        assert _post(srv.address, BODY)[0] == 200   # plans / programs warm
        fault.arm()
        results = []

        def one():
            results.append(_post(srv.address, BODY))

        threads = [threading.Thread(target=one) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        healed = _wait_for(lambda: len(srv._pool.replicas) == 2
                           and srv._pool.info()["restarts"] >= 1)
        health = _get_json(srv.address, "/health")
        return dict(
            codes=sorted(c for c, _ in results), fired=fault.fired,
            deaths=kit.replica._M_DEATHS.value(cause="injected"),
            requeued=kit.replica._M_REQUEUED.value() >= 1, healed=healed,
            restarts=kit.replica._M_RESTARTS.value() >= 1,
            status=health["status"],
            live=health["self_healing"]["pool"]["live"],
            outs=[np.asarray(d["outputs"][0]) for _, d in results])
    finally:
        srv.stop()


def test_replica_death_requeues_inflight_and_respawns(model_dir):
    got = _on_both(_death_scenario, model_dir)
    port, ref = got["port"], got["reference"]
    outs = port.pop("outs"), ref.pop("outs")
    assert port == ref
    assert port["codes"] == [200] * 6 and port["deaths"] == 1
    assert port["requeued"] and port["healed"] and port["status"] == "ok"
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _poison_scenario(kit, model_dir):
    fault = kit.replica.FaultInjector("raise", nth=1, repeat=True)
    srv = _serve(kit, model_dir, replicas=2, max_attempts=2,
                 replica_heartbeat_ms=50, chaos=fault)
    try:
        assert _post(srv.address, BODY)[0] == 200
        fault.arm()
        code, doc = _post(srv.address, BODY)
        fault.disarm()
        healed = _wait_for(lambda: len(srv._pool.replicas) >= 1)
        after = _post(srv.address, BODY)[0]
        return dict(
            code=code, reason=doc.get("reason"),
            quarantined="quarantined" in doc.get("error", ""),
            deaths=kit.replica._M_DEATHS.value(cause="exception"),
            healed=healed, after=after,
            rejected=kit.serving._M_REJECTED.value(reason="retry_exhausted",
                                                   tenant="default"))
    finally:
        srv.stop()


def test_poison_request_quarantined_after_max_attempts(model_dir):
    got = _on_both(_poison_scenario, model_dir)
    assert got["port"] == got["reference"]
    assert got["port"] == dict(code=503, reason="retry_exhausted",
                               quarantined=True, deaths=2, healed=True,
                               after=200, rejected=1)


def _hang_scenario(kit, model_dir):
    fault = kit.replica.FaultInjector("hang", nth=1, hang_s=0.8)
    srv = _serve(kit, model_dir, replicas=1, replica_heartbeat_ms=50,
                 dispatch_timeout=0.2, chaos=fault)
    try:
        assert _post(srv.address, BODY)[0] == 200
        fault.arm()
        t0 = time.monotonic()
        code, doc = _post(srv.address, BODY)
        # the supervisor swept the lease at ~0.2 s, requeued the batch
        # and a respawned replica answered it before the hang ended
        early = time.monotonic() - t0 < 0.8
        restarted = _wait_for(lambda: kit.replica._M_RESTARTS.value() >= 1)
        _join_zombies(srv)
        return dict(code=code, early=early, restarted=restarted,
                    deaths=kit.replica._M_DEATHS.value(cause="hang"),
                    requeued=kit.replica._M_REQUEUED.value(),
                    out=np.asarray(doc["outputs"][0]).round(5).tolist())
    finally:
        srv.stop()


def test_hung_dispatch_detected_via_lease_and_request_survives(model_dir):
    got = _on_both(_hang_scenario, model_dir)
    port, ref = got["port"], got["reference"]
    np.testing.assert_allclose(port.pop("out"), ref.pop("out"), atol=2e-5)
    assert port == ref
    assert port == dict(code=200, early=True, restarted=True, deaths=1,
                        requeued=1)


def _request_error_scenario(kit, model_dir):
    srv = _serve(kit, model_dir, replicas=1)
    try:
        # a wrong trailing shape runs solo and fails with the request's
        # own error: the replica must survive it
        code, _ = _post(srv.address, {"x": [[1.0, 2.0]]})
        return dict(code=code, deaths=kit.replica._M_DEATHS.value(),
                    live=len(srv._pool.replicas),
                    after=_post(srv.address, BODY)[0],
                    unbatched=kit.batching._M_UNBATCHED.value(
                        reason="shape_mismatch"))
    finally:
        srv.stop()


def test_request_level_errors_do_not_kill_the_replica(model_dir):
    got = _on_both(_request_error_scenario, model_dir)
    assert got["port"] == got["reference"]
    assert got["port"] == dict(code=400, deaths=0, live=1, after=200,
                               unbatched=1)


def test_fault_injector_spec_parsing_matches_the_reference():
    for spec in ("die@5", "hang@3:r1", "raise", " die@2:r0 ", "hang@"):
        p = pt_replica.FaultInjector.from_spec(spec)
        r = jax_replica.FaultInjector.from_spec(spec)
        assert (p.kind, p.nth, p.replica, p.hang_s, p.repeat, p._armed) == \
            (r.kind, r.nth, r.replica, r.hang_s, r.repeat, r._armed)
    f = pt_replica.FaultInjector.from_spec("hang@3:r1")
    assert (f.kind, f.nth, f.replica) == ("hang", 3, 1)
    for kit in KITS.values():
        with pytest.raises(ValueError):
            kit.replica.FaultInjector.from_spec("explode@2")
    # disarmed by default: dispatches before arm() never count; the nth
    # armed dispatch of the named replica fires once
    f = pt_replica.FaultInjector("raise", nth=2, replica=1)
    f.before_dispatch(1)
    f.arm()
    f.before_dispatch(0)
    f.before_dispatch(1)
    with pytest.raises(RuntimeError, match="replica 1"):
        f.before_dispatch(1)
    f.before_dispatch(1)
    assert f.fired == 1
    with pytest.raises(pt_replica.ReplicaDied):
        g = pt_replica.FaultInjector("die")
        g.arm()
        g.before_dispatch(0)


def _chaos_scenario(kit, model_dir):
    srv = _serve(kit, model_dir, replicas=2, replica_heartbeat_ms=50,
                 warmup=True, chaos="die@1")
    try:
        armed = srv.fault._armed
        code = _post(srv.address, BODY)[0]
        healed = _wait_for(lambda: len(srv._pool.replicas) == 2
                           and srv._pool.info()["restarts"] >= 1)
        return dict(armed=armed, code=code, fired=srv.fault.fired,
                    healed=healed,
                    ttr=kit.replica._M_TTR.count(
                        boot=srv._pool.boot_source()))
    finally:
        srv.stop()


def test_chaos_spec_string_is_armed_after_warmup(model_dir):
    got = _on_both(_chaos_scenario, model_dir)
    assert got["port"] == got["reference"]
    assert got["port"] == dict(armed=True, code=200, fired=1, healed=True,
                               ttr=1)


# -- pressure shedding and a degraded /health ------------------------------


def _shed_scenario(kit, model_dir):
    b = kit.batching
    srv = _serve(kit, model_dir, tenants="hi:::4,lo:::1", shed_watermark=4)
    seen = {}
    try:
        seen["first"] = _post(srv.address, dict(BODY, tenant="hi"))[0]
        srv.pause()
        junk = []

        def fill(n):
            for _ in range(n):
                r = b.PendingRequest({"x": np.ones((1, 4), np.float32)},
                                     rows=1, batchable=True, tenant="hi")
                srv._queue.submit(r)
                junk.append(r)

        fill(4)
        code, doc = _post(srv.address, dict(BODY, tenant="lo"), timeout=10)
        seen["lo"] = (code, doc.get("reason"))
        try:
            srv._queue.submit(b.PendingRequest(
                {"x": np.ones((1, 4), np.float32)}, rows=1, batchable=True,
                tenant="lo"))
        except b.QueueShed as e:
            seen["direct"] = e.reason
        health = _get_json(srv.address, "/health")
        seen["pressure"] = (health["status"], health["reasons"],
                            health["self_healing"]["queue"])
        fill(4)
        code, doc = _post(srv.address, dict(BODY, tenant="hi"), timeout=10)
        seen["hi"] = (code, doc.get("reason"))
        health = _get_json(srv.address, "/health")
        seen["collapse"] = (health["status"], health["reasons"],
                            health["self_healing"]["queue"],
                            sorted(health["self_healing"]["tenants"]))
        seen["rejected"] = kit.serving._M_REJECTED.value(
            reason="shed_low_weight", tenant="lo")
        depth = kit.batching._M_TENANT_DEPTH
        for r in junk:
            r.abandoned = True
        srv.resume()
        seen["drained"] = _wait_for(lambda: srv._queue.depth() == 0)
        seen["after"] = _post(srv.address, dict(BODY, tenant="lo"))[0]
        seen["healthy"] = _get_json(srv.address, "/health")["status"]
        seen["depth"] = depth.value(tenant="hi")
        return seen
    finally:
        srv.stop()


def test_shedding_rejects_low_weight_tenants_first(model_dir):
    got = _on_both(_shed_scenario, model_dir)
    assert got["port"] == got["reference"]
    port = got["port"]
    assert port["lo"] == (503, "shed_low_weight")
    assert port["hi"] == (503, "queue_collapse")
    assert port["direct"] == "shed_low_weight"
    assert port["pressure"][:2] == ("degraded",
                                    ["load_shedding:shed_low_weight"])
    assert port["collapse"][:2] == ("degraded",
                                    ["load_shedding:queue_collapse"])
    assert (port["after"], port["healthy"], port["depth"]) == (200, "ok", 0)
