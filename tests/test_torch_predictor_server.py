"""The port's PredictorServer (paddle_tpu_torch/inference.py) on the CPU:
rows against Predictor.run's and the JAX package's PredictorServer's on
one model the JAX package exported, then the JAX package's
test_serving_pipeline.py behaviours on the port: the request frame and
its pickle fallback, pow2 buckets and prewarm, the batching deadline,
timeout and cancel, the error path and its metrics, mismatched rows,
concurrent submitters, the stop flush, submit_frame and future
callbacks.

Tolerance: rows of a padded bucket against an unpadded run are the same
rows summed in another batch (the JAX package's padded-path class):
1e-5 abs / 2e-5 rel; the same path in both packages: 1e-5 / 1e-5."""
import pickle
import threading
import time

import numpy as np
import pytest
from _jax_metrics import jax_metrics_untouched

torch = pytest.importorskip("torch")

import paddle_tpu as fluid  # noqa: E402
from paddle_tpu import layers  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.inference import (  # noqa: E402
    Predictor, PredictorServer, _Future, _decode_request, _encode_request,
    _encode_sample)
from paddle_tpu_torch.runtime import recordio as rio  # noqa: E402

TOL = dict(atol=1e-5, rtol=2e-5)
DIM = 4


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The JAX package's fc model (test_serving_pipeline.py's), exported
    by it; the feed rows and its own outputs for them."""
    with jax_metrics_untouched():
        return _export_fc(str(tmp_path_factory.mktemp("fc_server")))


def _export_fc(d):
    mp, sp = fluid.Program(), fluid.Program()
    mp.random_seed = sp.random_seed = 5
    scope = fluid.Scope()
    with fluid.scope_guard(scope), fluid.program_guard(mp, sp):
        with fluid.unique_name.guard():
            x = layers.data(name="x", shape=[DIM])
            h = layers.fc(x, 8, act="relu")
            out = layers.fc(h, 3, act="softmax")
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(sp)
        fluid.io.save_inference_model(d, ["x"], [out], exe,
                                      main_program=mp, scope=scope)
        feed = np.linspace(-1, 1, 3 * DIM).reshape(3, DIM).astype(
            np.float32)
        want, = exe.run(mp, feed={"x": feed}, fetch_list=[out])
    return d, feed, np.asarray(want)


def _pred(model):
    return Predictor(model[0], place=pt.CPUPlace())


def _rows(n, seed=0):
    return np.random.RandomState(seed).randn(n, DIM).astype(np.float32)


def test_rows_match_predictor_run_and_jax_server(model):
    from paddle_tpu.inference import Predictor as JaxPredictor
    from paddle_tpu.inference import PredictorServer as JaxServer

    rows = _rows(11)
    p = _pred(model)
    want = p.run([rows])[0]
    srv = PredictorServer(p, max_batch=4)
    srv.start()
    got = [f.result(timeout=60)[0] for f in
           [srv.submit((r,)) for r in rows]]
    srv.stop()
    with jax_metrics_untouched():
        jsrv = JaxServer(JaxPredictor(model[0], aot_cache=False),
                         max_batch=4)
        jsrv.start()
        jgot = [f.result(timeout=60)[0] for f in
                [jsrv.submit((r,)) for r in rows]]
        jsrv.stop()
    for i, (g, j) in enumerate(zip(got, jgot)):
        np.testing.assert_allclose(g, want[i], err_msg=str(i), **TOL)
        np.testing.assert_allclose(g, j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(p.run([model[1]])[0], model[2], atol=1e-5,
                               rtol=1e-5)


def test_request_frame_roundtrip():
    rows = [np.arange(12, dtype=np.float32).reshape(3, 4),
            np.array([7, -1], dtype=np.int64),
            np.float32(2.5) * np.ones((), np.float32),
            np.zeros((0, 2), np.float64)]
    rid, back = _decode_request(_encode_request(123456789, rows))
    assert rid == 123456789 and len(back) == len(rows)
    for a, b in zip(rows, back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # byte for byte the JAX package's frame
    from paddle_tpu.inference import _encode_request as jax_encode

    assert _encode_request(7, rows) == jax_encode(7, rows)


def test_request_frame_pickle_fallback():
    rows = [np.array([1, 2], np.int32)]
    rid, back = _decode_request(b"P" + pickle.dumps((42, rows), protocol=4))
    assert rid == 42
    np.testing.assert_array_equal(back[0], rows[0])


def test_submit_noncontiguous_and_object_samples(model):
    _, feed, want = model
    srv = PredictorServer(_pred(model), max_batch=4)
    srv.start()
    wide = np.ascontiguousarray(np.stack([feed[0], feed[0]]).T)
    fut = srv.submit((wide[:, 0],))      # stride-2 view, not contiguous
    np.testing.assert_allclose(fut.result(timeout=60)[0], want[0], **TOL)
    obj = np.empty((1,), dtype=object)   # an object slot: pickle form
    obj[0] = "tag"
    assert _encode_sample(0, (feed[1], obj))[:1] == b"P"
    fut = srv.submit((feed[1], obj))     # slots past the feeds: unused
    np.testing.assert_allclose(fut.result(timeout=60)[0], want[1], **TOL)
    srv.stop()


def test_bucket_prewarm_no_build_in_traffic(model):
    _, feed, want = model
    p = _pred(model)
    srv = PredictorServer(p, max_batch=8)
    assert srv.buckets == [1, 2, 4, 8]
    srv.start()
    # every bucket's step is resident BEFORE any request
    sizes = {dict((n, s) for n, s, _ in st.meta["feed_sig"])["x"][0]
             for st in p._steps.steps()}
    assert sizes == {1, 2, 4, 8}
    traces = p.traces
    futs = [srv.submit((feed[i % 3],)) for i in range(11)]
    for i, fut in enumerate(futs):
        np.testing.assert_allclose(fut.result(timeout=60)[0], want[i % 3],
                                   **TOL)
    srv.stop()
    assert p.traces == traces and len(p._steps) == 4


def test_non_pow2_max_batch_is_a_bucket(model):
    srv = PredictorServer(_pred(model), max_batch=6, prewarm=False)
    assert srv.buckets == [1, 2, 4, 6]
    assert srv._bucket_for(5) == 6 and srv._bucket_for(1) == 1


def test_pad_rows_metrics(model):
    _, feed, _ = model
    srv = PredictorServer(_pred(model), max_batch=8)
    srv.start()
    real0 = obs.SERVER_ROWS.value(kind="real")
    pad0 = obs.SERVER_ROWS.value(kind="pad")
    for f in [srv.submit((feed[i],)) for i in range(3)]:
        f.result(timeout=60)
    srv.stop()
    assert obs.SERVER_ROWS.value(kind="real") - real0 == 3
    assert 0 <= obs.SERVER_ROWS.value(kind="pad") - pad0 <= 3


def test_deadline_single_request_completes(model):
    _, feed, want = model
    srv = PredictorServer(_pred(model), max_batch=8, max_wait_ms=100)
    srv.start()
    t0 = time.perf_counter()
    row = srv.submit((feed[0],)).result(timeout=30)
    elapsed = time.perf_counter() - t0
    srv.stop()
    np.testing.assert_allclose(row[0], want[0], **TOL)
    assert elapsed < 10.0


def test_deadline_coalesces_slow_submitters(model):
    _, feed, want = model
    srv = PredictorServer(_pred(model), max_batch=8, max_wait_ms=600,
                          pad_batches=False, prewarm=False)
    srv.start()
    futs = [srv.submit((feed[0],))]
    time.sleep(0.05)
    futs.append(srv.submit((feed[1],)))
    time.sleep(0.05)
    futs.append(srv.submit((feed[2],)))
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=30)[0], want[i], **TOL)
    srv.stop()
    assert max(srv.batch_size_counts) == 3, srv.batch_size_counts


def test_deadline_returns_early_when_full(model):
    _, feed, _ = model
    srv = PredictorServer(_pred(model), max_batch=2, max_wait_ms=5000)
    srv.start()
    t0 = time.perf_counter()
    for f in [srv.submit((feed[i],)) for i in range(2)]:
        f.result(timeout=30)
    elapsed = time.perf_counter() - t0
    srv.stop()
    assert elapsed < 4.0, "full batch waited for the deadline"


def test_timeout_abandons_request(model):
    _, feed, _ = model
    srv = PredictorServer(_pred(model), max_batch=4, prewarm=False)
    fut = srv.submit((feed[0],))          # not started: never completes
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.05)
    assert srv._results == {}, "timed-out entry leaked"
    srv.start()
    srv.submit((feed[1],)).result(timeout=60)
    srv.stop()
    assert srv._results == {}


def test_cancel_releases_entry_and_keeps_arrived_result(model):
    _, feed, _ = model
    srv = PredictorServer(_pred(model), max_batch=4, prewarm=False)
    fut = srv.submit((feed[0],))
    assert len(srv._results) == 1
    fut.cancel()
    assert srv._results == {}
    srv.start()
    fut2 = srv.submit((feed[0],))
    row = fut2.result(timeout=60)
    fut2.cancel()
    np.testing.assert_allclose(fut2.result(timeout=1)[0], row[0])
    srv.stop()


def test_error_path_records_failures_and_latency(model):
    _, feed, _ = model
    srv = PredictorServer(_pred(model), max_batch=4, prewarm=False)

    def boom(feed, **kwargs):
        raise RuntimeError("device on fire")

    srv.predictor = type("P", (), {"run": staticmethod(boom)})()
    fails0 = obs.PREDICT_FAILURES.value(path="server")
    lat0 = obs.PREDICT_LATENCY_MS.stats(path="server")["count"]
    srv.start()
    futs = [srv.submit((feed[i % 3],)) for i in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device on fire"):
            f.result(timeout=60)
    srv.stop()
    assert obs.PREDICT_FAILURES.value(path="server") - fails0 == 3
    assert obs.PREDICT_LATENCY_MS.stats(path="server")["count"] - lat0 == 3


def test_mismatched_row_shapes_fail_the_batch(model):
    _, feed, want = model
    srv = PredictorServer(_pred(model), max_batch=4, max_wait_ms=300,
                          prewarm=False)
    srv.start()
    f_ok = srv.submit((feed[0],))
    f_bad = srv.submit((feed[0][:2],))
    results = []
    for f in (f_ok, f_bad):
        try:
            results.append(f.result(timeout=60))
        except Exception as e:
            results.append(e)
    assert isinstance(results[1], Exception)
    if not isinstance(results[0], Exception):
        np.testing.assert_allclose(results[0][0], want[0], **TOL)
    np.testing.assert_allclose(srv.submit((feed[1],)).result(timeout=60)[0],
                               want[1], **TOL)
    srv.stop()


def test_concurrent_submitters_all_rows_correct(model):
    _, feed, want = model
    srv = PredictorServer(_pred(model), max_batch=4, in_flight=4)
    srv.start()
    errs = []

    def client(cid):
        try:
            rs = np.random.RandomState(cid)
            for _ in range(25):
                i = rs.randint(0, 3)
                row = srv.submit((feed[i],)).result(timeout=60)
                if not np.allclose(row[0], want[i], **{"atol": 1e-5,
                                                       "rtol": 2e-5}):
                    errs.append("client %d row %d diverged" % (cid, i))
        except Exception as e:  # pragma: no cover - failure reporting
            errs.append("client %d: %r" % (cid, e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    srv.stop()
    assert not errs, errs


def test_stop_flushes_queued_requests(model):
    _, feed, want = model
    srv = PredictorServer(_pred(model), max_batch=2, max_wait_ms=50)
    srv.start()
    futs = [srv.submit((feed[i % 3],)) for i in range(17)]
    srv.stop()
    for i, fut in enumerate(futs):
        row, = fut.result(timeout=60)
        np.testing.assert_allclose(row, want[i % 3], **TOL)
    assert srv._results == {}
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit((feed[0],))


def test_submit_frame_round_trip(model):
    _, feed, want = model
    srv = PredictorServer(_pred(model), max_batch=4)
    srv.start()
    msg = _encode_request(12345, [np.ascontiguousarray(feed[0])])
    assert rio.frame_tag(msg) == 12345
    np.testing.assert_allclose(srv.submit_frame(msg).result(timeout=60)[0],
                               want[0], **TOL)
    pmsg = b"P" + pickle.dumps((77, [feed[1]]), protocol=4)
    assert rio.frame_tag(pmsg) == 77
    np.testing.assert_allclose(srv.submit_frame(pmsg).result(timeout=60)[0],
                               want[1], **TOL)
    srv.stop()
    # a stopped server refuses; an in-flight duplicate tag is refused
    pending = PredictorServer(_pred(model), max_batch=4, prewarm=False)
    pending.submit_frame(_encode_request(9, [feed[2]]))
    with pytest.raises(ValueError, match="already in flight"):
        pending.submit_frame(_encode_request(9, [feed[2]]))
    with pytest.raises(RuntimeError, match="stopped"):
        srv.submit_frame(_encode_request(10, [feed[2]]))


def test_future_done_callback():
    fut = _Future()
    seen = []
    fut.add_done_callback(lambda f: seen.append(f.result(timeout=0)))
    fut.set_result([1, 2])
    assert seen == [[1, 2]]
    fut.add_done_callback(lambda f: seen.append("late"))
    assert seen == [[1, 2], "late"]
    bad = _Future()
    bad.add_done_callback(lambda f: seen.append(type(f._exc).__name__))
    bad.set_exception(KeyError("boom"))
    assert seen[-1] == "KeyError"


def test_series_match_the_jax_packages():
    """Every series the port registers has the JAX package's name, help,
    kind and buckets, so a dashboard reads either package's scrape."""
    from paddle_tpu import observability as jax_obs

    names = [n for n in obs.__all__ if n.isupper()
             and n not in ("REGISTRY", "TIMELINE")]
    assert {"PREDICT_LATENCY_MS", "SERVER_BUCKET_FILL", "DECODE_TOKENS",
            "COMPILE_TOTAL", "CACHE_HITS", "TRACE_SPANS"} <= set(names)
    for n in names:
        got, want = getattr(obs, n), getattr(jax_obs, n)
        assert (got.name, got.help, got.kind,
                getattr(got, "buckets", None)) == (
            want.name, want.help, want.kind,
            getattr(want, "buckets", None)), n
