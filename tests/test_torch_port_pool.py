"""The port's executor pool and per-bucket graph bookkeeping, on the CPU.

- The same seeded batches through a port ``ExecutorPool`` of 1 and of 2
  CPU members and through JAX's ``ExecutorPool`` of 1 and 2 virtual CPU
  devices (the conftest gives JAX 8), on the same weights
  (``models/weights.py``): ints equal on decisive rows, log-probs within
  atol 5e-4 / rtol 1e-4 (tests/test_torch_parity.py:76-77), the NaN mask
  identical; and ``shard_largest`` over 2 members against JAX's sharded
  largest bucket.
- Round-robin routing, collects routed to the dispatching member, and
  the refusals of ``tests/test_serve.py:530-551`` (mismatched members, a
  pool larger than the visible devices).
- The graph bookkeeping with stand-in capture and replay callables (a
  CUDA graph cannot be captured here): one capture per bucket at warmup
  and none after, the recorded launches added at every replay, outputs
  that survive the next replay of the same bucket, a capture asked for
  after warmup refused; and the resident lane's graphs per (rung, ring
  buffer).

Each test runs torch on one intra-op thread (the suite's xdist workers
share the host).
"""

import types

import jax
import numpy as np
import pytest
import torch

from dasmtl.export import make_serve_infer_fn as jax_serve_infer_fn
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.two_level import MTLNet as FlaxMTLNet
from dasmtl.parallel.mesh import fiber_placements as jax_fiber_placements
from dasmtl.parallel.mesh import infer_batch_sharding as jax_batch_sharding
from dasmtl.parallel.mesh import serve_shard_plan as jax_shard_plan
from dasmtl.serve.executor import ExecutorPool as JaxExecutorPool
from dasmtl.serve.executor import InferExecutor as JaxInferExecutor
from dasmtl_torch.ops import LaunchCounter, recorded_launches
from dasmtl_torch.parallel.placement import (fiber_placements,
                                             infer_batch_sharding,
                                             serve_shard_plan)
from dasmtl_torch.serve.executor import (ExecutorPool, InferExecutor,
                                         ShardedBatch, _pool_devices)
from dasmtl_torch.serve.graphs import (CapturedForward, GraphBook,
                                       OutputLayout, PostWarmupCapture,
                                       pull_outputs)
from dasmtl_torch.serve.server import ServeLoop
from tests.test_torch_port_weights import port_model, random_flax_variables

HW = (52, 64)
BUCKETS = (1, 2, 4, 8)
CPU = torch.device("cpu")
TOL = dict(atol=5e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    return random_flax_variables(FlaxMTLNet(), seed=17)


@pytest.fixture(scope="module")
def state_dict(weights):
    return port_model("MTL", weights).state_dict()


def _jax_fn(weights):
    state = types.SimpleNamespace(apply_fn=FlaxMTLNet().apply,
                                  params=weights["params"],
                                  batch_stats=weights["batch_stats"])
    return jax_serve_infer_fn(jax_model_spec("MTL"), state)


def _batches(seed=0):
    """Seeded batches of every bucket, one NaN row in each but the
    first."""
    rng = np.random.default_rng(seed)
    out = []
    for i, b in enumerate((8, 1, 4, 2, 8, 4)):
        x = rng.normal(size=(b, *HW, 1)).astype(np.float32)
        if i:
            x[b // 2, 3, 5, 0] = np.nan
        out.append(x)
    return out


def _held_to_jax(got, want, margin=1e-3) -> int:
    """Port ``(preds, bad, log_probs)`` against JAX's: the NaN mask
    identical, log-probs within TOL on finite rows, ints equal on
    decisive rows; the decisive rows checked."""
    (gp, gb, gl), (jp, jb, jl) = got, want
    assert np.array_equal(gb, jb)
    ok, n = ~jb, 0
    for i, task in enumerate(("distance", "event")):
        key = f"log_probs_{i}"
        np.testing.assert_allclose(gl[key][ok], jl[key][ok], **TOL)
        top2 = np.sort(jl[key], axis=-1)[:, -2:]
        decisive = ok & ((top2[:, 1] - top2[:, 0]) > margin)
        assert np.array_equal(gp[task][decisive], jp[task][decisive])
        n += int(decisive.sum())
    return n


def _run(pool, batches):
    handles = [pool.dispatch(x) for x in batches]
    return [pool.collect(h, want_log_probs=True) for h in handles]


@pytest.mark.parametrize("members", [1, 2])
def test_pool_answers_as_jax_pool(members, weights, state_dict):
    """A port pool of ``members`` CPU members against JAX's pool over as
    many virtual devices, batch for batch (round-robin on both)."""
    pool = ExecutorPool.from_state_dict("MTL", state_dict, BUCKETS, HW,
                                        CPU, devices=[CPU] * members)
    pool.warmup()
    fn = _jax_fn(weights)
    jpool = JaxExecutorPool([JaxInferExecutor(fn, HW, BUCKETS, placement=d)
                             for d in jax.devices()[:members]])
    batches = _batches()
    got, want = _run(pool, batches), _run(jpool, batches)
    assert sum(_held_to_jax(g, w) for g, w in zip(got, want)) >= 20
    summary = pool.compile_summary()
    assert summary["pool_size"] == members
    assert [p["placement"] for p in summary["per_device"]] == \
        ["cpu"] * members
    assert summary["post_warmup_compiles"] == 0
    pool.close()
    jpool.close()


def test_shard_largest_answers_as_jax_sharded_bucket(weights, state_dict):
    """``shard_largest`` over 2 members: a batch of the largest bucket
    runs as two 4-row blocks, one per member, concatenated in order; the
    answer is JAX's sharded largest bucket's over 2 devices."""
    pool = ExecutorPool.from_state_dict("MTL", state_dict, BUCKETS, HW,
                                        CPU, devices=[CPU, CPU],
                                        shard_largest=True)
    shard = pool.shard_executor
    assert [m.buckets for m in shard.members] == [(4,), (4,)]
    pool.warmup()
    fn = _jax_fn(weights)
    devs = jax.devices()[:2]
    jpool = JaxExecutorPool(
        [JaxInferExecutor(fn, HW, BUCKETS, placement=d) for d in devs],
        JaxInferExecutor(fn, HW, (8,), placement=jax_batch_sharding(
            jax_shard_plan(devs))))
    batches = [x for x in _batches(seed=3) if x.shape[0] == 8]
    handle = pool.dispatch(batches[0])
    assert isinstance(handle, ShardedBatch) and len(handle.parts) == 2
    assert [p.bucket for p in handle.parts] == [4, 4]
    got = [pool.collect(handle, want_log_probs=True)]
    got += _run(pool, batches[1:])
    want = _run(jpool, batches)
    assert sum(_held_to_jax(g, w) for g, w in zip(got, want)) >= 10
    assert pool.compile_summary()["shard_largest"]["block_rows"] == 4
    pool.close()
    jpool.close()


def test_shard_largest_refusals_and_one_member():
    """One member: no sharding (JAX's "a 1-device mesh is just the plain
    member"); a largest bucket not divisible by the member count raises
    JAX's message."""
    pool = ExecutorPool.from_fresh_init("MTL", (1, 2), HW, 0, CPU,
                                        devices=1, shard_largest=True)
    assert pool.shard_executor is None
    with pytest.raises(ValueError, match=r"largest bucket \(3\) divisible "
                                         r"by the mesh size \(2\)"):
        ExecutorPool.from_fresh_init("MTL", (1, 3), HW, 0, CPU,
                                     devices=[CPU, CPU], shard_largest=True)


def _tiny_fn(x):
    with torch.inference_mode():
        m = x.float().mean(dim=(1, 2, 3))
        return {"event": (m > 0).to(torch.int32),
                "bad_rows": ~torch.isfinite(m),
                "log_probs_0": torch.stack([m, -m], dim=-1)}


def test_pool_round_robin_and_collect_routing():
    """Batches alternate over the members, each handle names the member
    that dispatched it, and the collect goes through that member."""
    members = [InferExecutor(_tiny_fn, HW, (1, 2), CPU) for _ in range(2)]
    pool = ExecutorPool(members)
    x = np.ones((1, *HW, 1), np.float32)
    handles = [pool.dispatch(x) for _ in range(4)]
    assert [h.executor for h in handles] == members * 2
    preds, bad, lp = pool.collect(handles[0], want_log_probs=True)
    assert preds["event"][0] == 1 and not bad[0]
    assert lp["log_probs_0"].shape == (1, 2)
    summary = pool.compile_summary()
    assert summary["pool_size"] == 2 and len(summary["per_device"]) == 2
    pool.close()
    assert all(m.closed for m in members)


def test_pool_refuses_mismatched_members_and_too_many_devices():
    with pytest.raises(ValueError, match="disagree"):
        ExecutorPool([InferExecutor(_tiny_fn, HW, (1, 2), CPU),
                      InferExecutor(_tiny_fn, HW, (1, 4), CPU)])
    with pytest.raises(ValueError, match="disagree"):
        ExecutorPool([InferExecutor(_tiny_fn, HW, (1, 2), CPU),
                      InferExecutor(_tiny_fn, (64, 64), (1, 2), CPU)])
    with pytest.raises(ValueError, match="pool of 2 devices requested, "
                                         "1 visible"):
        ExecutorPool.from_fresh_init("MTL", (1,), HW, 0, CPU, devices=2)
    assert _pool_devices(-1, CPU) == [CPU]
    assert _pool_devices([CPU, "cpu"], CPU) == [CPU, CPU]
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="pool of 1 devices requested, "
                                             "0 visible"):
            _pool_devices(1, torch.device("cuda"))


def test_placement_matches_jax_mesh_helpers():
    """Fibers round-robin as JAX places them, and a batch's row blocks
    follow the dp axis's contiguous split."""
    devs = [CPU, CPU, CPU]
    assert [i for i, _ in fiber_placements(7, devs)] == \
        [i for i, _ in jax_fiber_placements(7, jax.devices()[:3])]
    assert fiber_placements(2) == [(0, None), (0, None)]
    blocks = infer_batch_sharding(serve_shard_plan(devs[:2]), 8)
    assert [r for _, r in blocks] == [slice(0, 4), slice(4, 8)]
    with pytest.raises(ValueError, match="does not split evenly"):
        infer_batch_sharding(serve_shard_plan(devs), 8)
    with pytest.raises(ValueError, match="at least one fiber"):
        fiber_placements(0, devs)


def test_serve_loop_over_a_pool_and_a_swap_between_pools(state_dict):
    """The loop is device-count agnostic: it serves a 2-member pool
    (staging unpinned on the CPU), its stats carry the pool summary, and
    a swap to a 1-member pool (other devices: new staging) answers every
    request."""
    pool = ExecutorPool.from_state_dict("MTL", state_dict, BUCKETS, HW,
                                        CPU, devices=[CPU, CPU])
    loop = ServeLoop(pool, buckets=BUCKETS, max_wait_s=0.002,
                     queue_depth=64).start()
    rng = np.random.default_rng(1)
    windows = rng.normal(size=(12, *HW)).astype(np.float32)
    first = [loop.submit_async(w) for w in windows]
    assert all(f.result(60).ok for f in first)
    staging = loop._staging
    loop.swap_executor(ExecutorPool.from_state_dict(
        "MTL", state_dict, BUCKETS, HW, CPU, devices=[CPU]))
    assert loop._staging is not staging
    later = [loop.submit_async(w) for w in windows]
    assert all(f.result(60).ok for f in later)
    stats = loop.stats()
    loop.close()
    assert stats["executor"]["pool_size"] == 1
    assert stats["executor"]["post_warmup_compiles"] == 0
    assert [f.result().predictions for f in first] == \
        [f.result().predictions for f in later]
    assert pool.executors[0].closed and pool.executors[1].closed


# -- graph bookkeeping with stand-ins -----------------------------------------

def _standin_capture(log, counter):
    """A stand-in for ``capture_forward``: "capturing" records the
    shapes and one launch of ``counter`` (recorded, not counted, as a
    capture's are); a replay reruns the forward into the one flat
    output buffer, as a graph rewrites its static outputs."""

    def capture(fn, inputs, *, stream, pool, device):
        log.append(tuple(tuple(t.shape) for t in inputs))
        with torch.inference_mode(), recorded_launches() as launches:
            out = fn(*inputs)
            counter.add()
            layout = OutputLayout.of(out)
            flat = torch.zeros(layout.nbytes, dtype=torch.uint8)

        def replay():
            with torch.inference_mode():
                layout.pack(fn(*inputs), flat)

        return CapturedForward(replay, inputs, flat, layout, launches)

    return capture


def test_one_capture_per_bucket_at_warmup_and_launches_per_replay(
        state_dict):
    """Warmup captures each bucket once over a static input of its own;
    dispatches after it capture nothing, each replay adds the recorded
    launches, and the answers are the eager executor's."""
    log, counter = [], LaunchCounter()
    graph = InferExecutor.from_state_dict("MTL", state_dict, BUCKETS, HW,
                                          CPU)
    graph = InferExecutor(graph._fn, HW, BUCKETS, CPU,
                          capture=_standin_capture(log, counter))
    eager = InferExecutor.from_state_dict("MTL", state_dict, BUCKETS, HW,
                                          CPU)
    assert eager.eager and not graph.eager and graph.graph_capture
    graph.warmup()
    assert log == [((b, *HW, 1),) for b in BUCKETS]
    assert counter.value == len(BUCKETS)  # the warmup's replays, one each
    summary = graph.compile_summary()
    assert summary["graph_count"] == summary["warmup_compiles"] == 4
    counter.reset()
    for x in _batches(seed=5):
        got = graph.collect(graph.dispatch(x), want_log_probs=True)
        want = eager.collect(eager.dispatch(x), want_log_probs=True)
        for a, b in zip(got, want):
            for k in b if isinstance(b, dict) else [None]:
                np.testing.assert_array_equal(
                    a[k] if k else a, b[k] if k else b)
    assert counter.value == 6 and len(log) == len(BUCKETS)
    assert graph.post_warmup_compiles == 0
    graph.close()
    closed = graph.compile_summary()  # the counts outlive the graphs
    assert (closed["graph_count"], closed["warmup_compiles"]) == (0, 4)


def test_outputs_survive_the_next_replay_of_their_bucket(state_dict):
    """Three batches of one bucket dispatched before the first collect:
    each dispatch clones the graph's outputs, so each answer is its own
    batch's though every replay rewrote the same buffer."""
    log, counter = [], LaunchCounter()
    fn = InferExecutor.from_state_dict("MTL", state_dict, (4,), HW, CPU)._fn
    graph = InferExecutor(fn, HW, (4,), CPU,
                          capture=_standin_capture(log, counter))
    graph.warmup()
    rng = np.random.default_rng(9)
    xs = [rng.normal(size=(4, *HW, 1)).astype(np.float32) * (i + 1)
          for i in range(3)]
    handles = [graph.dispatch(x) for x in xs]
    assert len({h.flat.data_ptr() for h in handles}) == 3
    for h, x in zip(handles, xs):
        preds, bad, lp = graph.collect(h, want_log_probs=True)
        want = fn(torch.from_numpy(x))
        np.testing.assert_array_equal(lp["log_probs_0"],
                                      want["log_probs_0"].numpy())
        np.testing.assert_array_equal(preds["distance"],
                                      want["distance"].numpy())


def test_graph_book_refuses_a_capture_after_warmup():
    """Before warmup a missing key is captured when first asked for;
    after it, asking counts a post-warmup capture and raises without
    capturing."""
    made = []
    book = GraphBook(lambda key: made.append(key) or types.SimpleNamespace(
        key=key))
    assert book.entry(2).key == 2 and book.entry(2).key == 2
    assert made == [2] and book.warmup_captures == 1
    book.finish_warmup()
    assert book.entry(2).key == 2
    with pytest.raises(PostWarmupCapture, match="after warmup"):
        book.entry(4)
    assert made == [2] and book.post_warmup_captures == 1 and 4 not in book
    book.close()
    assert len(book) == 0 and book.post_warmup_captures == 1


def test_output_layout_packs_ints_first_and_pulls_them_alone():
    """Mixed dtypes in one 16-byte-aligned flat buffer; the collect pulls
    the head (ints, bad_rows) alone unless the heads are asked for."""
    out = {"log_probs_0": torch.randn(3, 16), "distance":
           torch.tensor([1, 2, 3], dtype=torch.int32),
           "bad_rows": torch.tensor([False, True, False]),
           "event_prob_q": torch.tensor([5, 6, 7], dtype=torch.int32)}
    layout = OutputLayout.of(out)
    assert [e.key for e in layout.entries] == \
        ["distance", "bad_rows", "event_prob_q", "log_probs_0"]
    assert all(e.offset % 16 == 0 for e in layout.entries)
    assert layout.head == 48 and layout.nbytes == 48 + 3 * 16 * 4
    flat = torch.zeros(layout.nbytes, dtype=torch.uint8)
    layout.pack(out, flat)
    head = pull_outputs(flat=flat, layout=layout)
    assert sorted(head) == ["bad_rows", "distance", "event_prob_q"]
    full = pull_outputs(flat=flat, layout=layout, want_log_probs=True)
    for k, v in out.items():
        np.testing.assert_array_equal(full[k], v.numpy())


def test_resident_lane_graphs_per_rung_and_ring_buffer():
    """The resident lane of a stand-in graph member captures every rung
    over both ring buffers at warmup, picks the graph of the buffer the
    ring is in after each append, and answers as the eager lane."""
    from dasmtl_torch.stream.feed import SyntheticSource
    from dasmtl_torch.stream.live import StreamTenant
    from dasmtl_torch.stream.resident import build_lanes
    from dasmtl_torch.stream.selftest import _oracle_infer_fn
    from dasmtl_torch.stream.windower import LiveWindower

    log, counter = [], LaunchCounter()
    lanes = []
    for capture in (_standin_capture(log, counter), None):
        member = InferExecutor(_oracle_infer_fn(), (64, 64), (1, 2), CPU,
                               capture=capture)
        tenant = StreamTenant("f0", SyntheticSource(64, seed=2),
                              window=(64, 64), stride_time=32,
                              ring_samples=256, chunk_samples=64)
        (lane,) = build_lanes(ExecutorPool([member]), [tenant],
                              max_windows=4)
        lanes.append(lane)
    graph, eager = lanes
    rungs = graph.executor.rungs
    assert graph.executor.graph_count == 2 * len(rungs) == len(log)
    assert eager.executor.graph_count == 0 and eager.executor.eager
    rng = np.random.default_rng(3)
    data = (rng.normal(size=(64, 64 * 12))
            * rng.uniform(0.5, 8.0, size=(64, 1))).astype(np.float32)
    cutters = [LiveWindower(lane.feed, (64, 64), stride_time=32)
               for lane in lanes]
    n = 0
    for c0 in range(0, data.shape[1], 64):
        for lane in lanes:
            lane.feed.append(data[:, c0:c0 + 64])
        cuts = [w.cut(4, pixels=False) for w in cutters]
        if not cuts[0]:
            continue
        got, want = (lane.executor.collect(lane.dispatch_windows(c),
                                           want_log_probs=True)
                     for lane, c in zip(lanes, cuts))
        for a, b in zip(got[:3], want[:3]):
            if isinstance(a, dict):
                assert all(np.array_equal(a[k], b[k]) for k in b)
            else:
                np.testing.assert_array_equal(a, b)
        n += len(cuts[0])
    assert n >= 10 and len(log) == 2 * len(rungs)
    assert graph.executor.post_warmup_compiles == 0
