"""The port's serving slice as a whole, on the CPU: batcher, staging,
executor, ``ServeLoop``, the HTTP front end and the CLI.

The slice is held to the JAX package: a CPU ``ServeLoop`` over
``InferExecutor`` at (52, 64) with buckets (1, 2, 4, 8) answers seeded
windows, every 7th NaN-poisoned, with the same ints (on decisive rows) and
the same ``bad_rows`` as JAX ``make_serve_infer_fn`` on the same weights.
"""

import json
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl.export import make_serve_infer_fn as jax_serve_infer_fn
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.two_level import MTLNet as FlaxMTLNet
from dasmtl_torch.config import serve_watermark
from dasmtl_torch.export import make_serve_infer_fn
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.serve.__main__ import main as serve_main
from dasmtl_torch.serve.batcher import (BatchPlan, MicroBatcher,
                                        StagingBuffers, choose_bucket)
from dasmtl_torch.serve.executor import InferExecutor
from dasmtl_torch.serve.queue import Request
from dasmtl_torch.serve.server import (EVENT_NAMES, ServeLoop,
                                       make_http_server)
from tests.test_torch_port_weights import port_model, random_flax_variables

HW = (52, 64)
BUCKETS = (1, 2, 4, 8)
CPU = torch.device("cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _windows(n, seed=0, poison_every=7):
    x = np.random.default_rng(seed).normal(size=(n, *HW)).astype(np.float32)
    if poison_every:
        x[::poison_every, 5, 7] = np.nan
    return x


@pytest.fixture(scope="module")
def weights():
    return random_flax_variables(FlaxMTLNet(), seed=31)


@pytest.fixture
def executor(weights):
    net = port_model("MTL", weights)
    return InferExecutor(make_serve_infer_fn(get_model_spec("MTL"), net),
                         HW, BUCKETS, CPU)


@pytest.fixture
def http_loop(executor):
    loop = ServeLoop(executor, buckets=BUCKETS, max_wait_s=0.002,
                     queue_depth=32).start()
    httpd = make_http_server(loop, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield loop, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    t.join(timeout=5)
    httpd.server_close()
    loop.close()


def _call(url, body=None):
    req = urllib.request.Request(url, data=body,
                                 method="POST" if body else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# -- batcher / staging ---------------------------------------------------------
def test_choose_bucket_and_watermark_rule():
    assert [choose_bucket(n, BUCKETS) for n in (1, 2, 3, 5, 8)] == \
        [1, 2, 4, 8, 8]
    with pytest.raises(ValueError):
        choose_bucket(9, BUCKETS)
    assert serve_watermark((1, 2, 4, 8, 16, 32), 256) == 230
    assert serve_watermark((1, 32), 20) == 32
    assert serve_watermark((1, 32), 256, watermark=7) == 7


def test_batcher_flushes_on_deadline_size_and_drain():
    clock = FakeClock()
    b = MicroBatcher(BUCKETS, 0.005, queue_depth=16, watermark=12,
                     clock=clock)
    for _ in range(3):
        b.submit(np.zeros(HW, np.float32))
    assert b.take_batch() is None and b.ready_at() == pytest.approx(0.005)
    clock.t = 0.005
    plan = b.take_batch()
    assert (plan.n_real, plan.bucket) == (3, 4)
    for _ in range(9):
        b.submit(np.zeros(HW, np.float32))
    assert b.take_batch().n_real == 8  # size cap, before the deadline
    b.begin_drain()
    assert b.take_batch().n_real == 1
    late = b.submit(np.zeros(HW, np.float32))
    assert late.future.result(0).error == "closed"


def test_batcher_sheds_at_watermark():
    b = MicroBatcher(BUCKETS, 1.0, queue_depth=8, watermark=2,
                     clock=FakeClock())
    reqs = [b.submit(np.zeros(HW, np.float32)) for _ in range(3)]
    assert not reqs[0].future.done()
    assert reqs[2].future.result(0).error == "shed"


def test_staging_buffers_share_memory_and_recycle():
    s = StagingBuffers.for_buckets(BUCKETS, HW, depth=2)
    slot = s.acquire(4)
    assert tuple(slot.tensor.shape) == (4, *HW, 1)
    assert not slot.tensor.is_pinned()  # pinned only for a CUDA executor
    plan = BatchPlan(requests=[Request(id=0, x=np.full(HW, 5.0, np.float32),
                                       enqueue_t=0.0, deadline_t=0.0)],
                     bucket=4)
    slot.tensor.fill_(7.0)
    assert plan.assemble_into(slot.tensor) is slot.tensor
    assert slot.tensor[0, 2, 3, 0].item() == 5.0
    assert not slot.tensor[1:].any()
    s.release(slot)
    assert s.stats()["outstanding"] == 0 and s.stats()["acquires"] == 1


# -- executor ------------------------------------------------------------------
def test_executor_contract(executor):
    x = _windows(4)[..., None]
    with pytest.raises(ValueError, match="not a configured bucket"):
        executor.dispatch(x[:3])
    preds, bad, lp = executor.collect(executor.dispatch(x),
                                      want_log_probs=True)
    assert sorted(preds) == ["distance", "event"]
    assert preds["distance"].dtype == np.int32 and bad.dtype == bool
    assert bad.tolist() == [True, False, False, False]
    assert lp["log_probs_0"].shape == (4, 16)
    assert lp["log_probs_1"].shape == (4, 2)
    preds2, bad2 = executor.run(x)
    assert executor.collect(executor.dispatch(x))[2] is None
    np.testing.assert_array_equal(preds2["event"], preds["event"])
    assert executor.warmup() >= 0.0
    assert executor.compile_summary()["warm"] is True


def test_from_fresh_init_is_seeded():
    a = InferExecutor.from_fresh_init("MTL", (2,), HW, 5, CPU)
    b = InferExecutor.from_fresh_init("MTL", (2,), HW, 5, CPU)
    x = _windows(2, seed=3, poison_every=0)[..., None]
    pa, pb = a.run(x), b.run(x)
    for k in pa[0]:
        np.testing.assert_array_equal(pa[0][k], pb[0][k])
    with pytest.raises(ValueError, match="unknown model"):
        InferExecutor.from_fresh_init("model_d", (1,), HW, 0, CPU)


# -- the slice against JAX -------------------------------------------------------
def test_serve_loop_matches_jax_serve_infer_fn(executor, weights):
    windows = _windows(21)
    loop = ServeLoop(executor, buckets=BUCKETS, max_wait_s=0.002,
                     queue_depth=64, inflight=2).start()
    futures = [loop.submit_async(w) for w in windows]
    results = [f.result(60) for f in futures]
    assert loop.drain(timeout=30)
    loop.close()

    state = types.SimpleNamespace(apply_fn=FlaxMTLNet().apply,
                                  params=weights["params"],
                                  batch_stats=weights["batch_stats"])
    jax_out = jax.jit(jax_serve_infer_fn(jax_model_spec("MTL"), state))(
        jnp.asarray(windows[..., None]))
    want_bad = np.asarray(jax_out["bad_rows"])
    assert want_bad.tolist() == [j % 7 == 0 for j in range(21)]
    n_checked = 0
    for j, res in enumerate(results):
        assert res.outcome == ("nonfinite" if want_bad[j] else "ok")
        if want_bad[j]:
            continue
        for i, task in enumerate(("distance", "event")):
            lp = np.sort(np.asarray(jax_out[f"log_probs_{i}"][j]))
            if lp[-1] - lp[-2] > 1e-3:
                assert res.predictions[task] == int(jax_out[task][j])
                n_checked += 1
        assert res.predictions["event_name"] == \
            EVENT_NAMES[res.predictions["event"]]
    assert n_checked >= 24
    assert loop.stats()["requests"]["answered"] == 21


def test_executor_failure_answers_every_caller(executor):
    def broken(x):
        raise RuntimeError("planted")

    ex = InferExecutor(broken, HW, BUCKETS, CPU)
    ex.warmup = lambda: 0.0
    loop = ServeLoop(ex, buckets=BUCKETS, max_wait_s=0.001).start()
    res = [loop.submit(w, timeout=10) for w in _windows(2, poison_every=0)]
    assert [r.error for r in res] == ["error", "error"]
    assert "planted" in res[0].detail
    loop.close()


def test_drain_resolves_everything_and_refuses_after(executor):
    loop = ServeLoop(executor, buckets=BUCKETS, max_wait_s=10.0,
                     queue_depth=64).start()
    futures = [loop.submit_async(w) for w in _windows(5, poison_every=0)]
    assert loop.drain(timeout=30)  # flushes despite the 10 s deadline
    assert [f.result(0).outcome for f in futures] == ["ok"] * 5
    assert loop.submit(_windows(1)[0], timeout=5).error == "closed"
    assert not loop.ready
    loop.close()


# -- HTTP ----------------------------------------------------------------------
def test_http_infer_answers_and_rejects(http_loop):
    loop, base = http_loop
    assert _call(f"{base}/healthz")[0] == 200
    code, h = _call(f"{base}/readyz")
    assert code == 200 and h["ready"]
    w = _windows(2, seed=9, poison_every=0)
    code, out = _call(f"{base}/infer", json.dumps({"x": w[0].tolist()})
                      .encode())
    assert code == 200 and out["ok"]
    # The answer names its span chain in GET /trace.
    assert out["trace_id"] in loop.tracer.chains()
    pred = out["predictions"]
    assert set(pred) == {"distance", "event", "event_name"}
    assert pred["event_name"] == EVENT_NAMES[pred["event"]]
    code, out = _call(f"{base}/infer", json.dumps(
        {"x": w[1][..., None].tolist(), "log_probs": True}).encode())
    assert code == 200 and len(out["log_probs"]["log_probs_0"]) == 16
    poisoned = w[0].copy()
    poisoned[0, 0] = np.nan
    code, out = _call(f"{base}/infer",
                      json.dumps({"x": poisoned.tolist()}).encode())
    assert code == 422 and out["error"] == "nonfinite"
    assert _call(f"{base}/infer", b'{"x": [[1.0, 2.0]]}')[0] == 400
    assert _call(f"{base}/infer", b'{"y": 1}')[0] == 400
    assert _call(f"{base}/nope")[0] == 404
    code, stats = _call(f"{base}/stats")
    assert code == 200 and stats["requests"]["ok"] == 2
    assert stats["requests"]["nonfinite"] == 1
    loop.begin_drain()
    assert _call(f"{base}/healthz")[0] == 503
    assert _call(f"{base}/readyz")[0] == 503
    code, out = _call(f"{base}/infer", json.dumps({"x": w[0].tolist()})
                      .encode())
    assert code == 503 and out["error"] == "closed"


# -- CLI -----------------------------------------------------------------------
def _exit_code(main, argv) -> int:
    try:
        return main(argv)
    except SystemExit as exc:  # argparse's p.error
        return exc.code


@pytest.mark.parametrize("argv, said", [
    (["--model_path", "ckpt"], "no port checkpoint at ckpt"),
    (["--exported", "jax.stablehlo"], "scripts/convert_jax_checkpoint.py"),
    (["--registry", "reg"], "holds no readable versions"),
    (["--parity-check", "--model_path", "ckpt"],
     "no port checkpoint at ckpt"),
    (["--fresh_init", "--model", "multi_classifier", "--exported", "a"],
     "exactly one of --exported / --model_path / --fresh_init")])
def test_cli_refuses_what_is_not_ported(argv, said, tmp_path, monkeypatch,
                                        capsys):
    """Each model source now serves; what it cannot serve exits 2 with an
    operational message, as the JAX server refuses it: a missing
    checkpoint, a JAX StableHLO artifact (naming the converter),
    an empty registry, two sources at once."""
    from dasmtl.export import ARTIFACT_VERSION, pack_artifact

    monkeypatch.chdir(tmp_path)
    (tmp_path / "jax.stablehlo").write_bytes(pack_artifact(
        b"stablehlo", {"artifact_version": ARTIFACT_VERSION,
                       "precision": "f32", "model": "MTL",
                       "input_hw": list(HW)}))
    assert _exit_code(serve_main, argv + ["--device", "cpu"]) == 2
    assert said in capsys.readouterr().err


#: How long the serve CLI gets to answer ``/readyz`` and install its drain
#: handler: ~3 s alone on the CPU, far more beside a loaded test run's
#: other workers.
READY_DEADLINE_S = 120.0


class _ReadyzMissed(Exception):
    pass


def _serve_until_sigterm(argv, tmp_path) -> int:
    """Run the serve CLI in this process on one intra-op thread; once
    ``/readyz`` answers 200 and the CLI has installed its SIGTERM handler,
    SIGTERM the process (the handler drains); its exit code.  A SIGTERM
    between the two would take the process down, so until the CLI's
    handler is in place this helper's own stands: if ``/readyz`` misses
    its deadline, the signal it then sends fails the test naming the
    missed ``/readyz``.  The signal handlers are put back."""
    import os
    import signal
    import time

    port_file = tmp_path / "port"
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    threads = torch.get_num_threads()
    missed = []

    def not_ready(_signum, _frame):
        raise _ReadyzMissed

    def stop_when_ready():
        deadline = time.monotonic() + READY_DEADLINE_S
        while time.monotonic() < deadline:
            try:
                port = port_file.read_text().strip()
                ready = bool(port) and _call(
                    f"http://127.0.0.1:{port}/readyz")[0] == 200
            except (OSError, ValueError):
                ready = False
            if ready and signal.getsignal(signal.SIGTERM) is not not_ready:
                break
            time.sleep(0.05)
        else:
            missed.append(True)
        os.kill(os.getpid(), signal.SIGTERM)

    torch.set_num_threads(1)
    signal.signal(signal.SIGTERM, not_ready)
    stopper = threading.Thread(target=stop_when_ready, daemon=True)
    stopper.start()
    try:
        code = serve_main(argv + ["--window", "52x64", "--buckets", "1,2",
                                  "--port", "0", "--port_file",
                                  str(port_file), "--device", "cpu"])
    except _ReadyzMissed:
        code = None
    finally:
        stopper.join(timeout=READY_DEADLINE_S + 10)
        for s, handler in prev.items():
            signal.signal(s, handler)
        torch.set_num_threads(threads)
    if missed:
        pytest.fail(f"the serve CLI's /readyz did not answer 200 (with its "
                    f"SIGTERM handler installed) within {READY_DEADLINE_S:g}"
                    f" s; SIGTERM sent then")
    return code


@pytest.mark.parametrize("argv, item", [
    (["--devices", "1"], None), (["--shard_largest"], None),
    (["--shard_multihost"], "item 4"),
    (["--conc_lockdep"], "item 3"), (["--mem_track"], "item 3"),
    (["--selftest", "--selftest_requests", "16"], None)],
    ids=["devices", "shard_largest", "shard_multihost", "conc", "mem",
         "selftest"])
def test_cli_jax_only_flags_exit_2_naming_their_item(argv, item, capsys,
                                                     tmp_path):
    """A flag of the JAX server the port does not carry exits 2 naming
    its ROADMAP.md item.  The executor pool's flags (item 4) are ported
    but for ``--shard_multihost``: ``--devices 1`` and ``--shard_largest``
    (one member: no sharding) serve and drain clean on the CPU, and
    ``--selftest`` runs the soak and exits 0."""
    if item is None:
        if argv[0] == "--selftest":
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                assert serve_main(argv + ["--device", "cpu"]) == 0
            finally:
                torch.set_num_threads(threads)
            assert "[serve-selftest] PASSED" in capsys.readouterr().out
            return
        assert _serve_until_sigterm(["--fresh_init"] + argv, tmp_path) == 0
        err = capsys.readouterr().err
        assert "on a pool of 1 (cpu)" in err and "drained=clean" in err
        return
    assert serve_main(["--fresh_init"] + argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert f"ROADMAP.md queue 1 {item}" in err and "not yet ported" in err
    assert argv[0].split("=")[0] in err


@pytest.mark.parametrize("version, said", [
    ("v1", "bad registry version 'v1' (an int or 'latest'); available: v1"),
    ("9", "has no version 9; available: v1")])
def test_cli_registry_version_is_refused_as_jax_refuses_it(
        version, said, weights, tmp_path, capsys):
    """``--registry_version`` is ported: a version the registry cannot
    resolve exits 2 with the JAX registry's message."""
    from dasmtl_torch.export import ArtifactRegistry, export_infer

    reg = str(tmp_path / "reg")
    ArtifactRegistry(reg).publish(export_infer(
        get_model_spec("MTL"), port_model("MTL", weights), input_hw=HW))
    assert serve_main(["--registry", reg, "--registry_version", version,
                       "--device", "cpu"]) == 2
    assert said in capsys.readouterr().err


def test_cli_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_main(["--fresh_init", "--window", "52x64", "--port", "0"])


# -- concurrency ---------------------------------------------------------------
def test_many_clients_each_get_exactly_one_answer():
    """More submitting threads than cores, a short switch interval: every
    request resolves once, and the counters add up."""
    import sys

    from dasmtl_torch.models.two_level import TwoLevelNet
    from dasmtl_torch.models.weights import init_fresh
    from dasmtl_torch.ops import LaunchCounter

    net = init_fresh(TwoLevelNet(first_ch=8), seed=0).eval()
    ex = InferExecutor(make_serve_infer_fn(get_model_spec("MTL"), net), HW,
                       BUCKETS, CPU)
    loop = ServeLoop(ex, buckets=BUCKETS, max_wait_s=0.001,
                     queue_depth=512).start()
    windows = _windows(4, poison_every=2)
    counter = LaunchCounter()
    answers = [[] for _ in range(16)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(k):
            for i in range(12):
                counter.add()
                answers[k].append(loop.submit(windows[(k + i) % 4],
                                              timeout=60))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert loop.drain(timeout=30)
    loop.close()
    flat = [r for a in answers for r in a]
    assert counter.value == len(flat) == 16 * 12
    assert len({r.request_id for r in flat}) == len(flat)
    assert sorted({r.outcome for r in flat}) == ["nonfinite", "ok"]
    req = loop.stats()["requests"]
    assert req["answered"] == req["submitted"] == len(flat)
    assert req["ok"] == req["nonfinite"] == len(flat) // 2
