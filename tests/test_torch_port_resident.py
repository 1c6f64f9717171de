"""The port's resident data plane on the CPU, held to the JAX package.

The plain versions of the three stream kernels against the JAX programs
they replace — the window gather against ``jax.vmap(lax.dynamic_slice)``
(clamped origins included), the ring append against JAX's
``ResidentFeed`` over ragged appends, ``event_prob_q`` against
``dasmtl/export.py:188-192`` — then the window grid against
``dasmtl/data/windowing.py`` and the port's oracle ``ResidentLane``
against its own host forward (``tests/test_stream_resident.py:88-142``).
Inputs are numpy arrays made from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasmtl.data import windowing as jax_windowing
from dasmtl.export import PROB_Q_SCALE as JAX_PROB_Q_SCALE
from dasmtl.stream.feed import FiberFeed as JaxFiberFeed
from dasmtl.stream.resident import ResidentFeed as JaxResidentFeed
from dasmtl_torch.data import windowing
from dasmtl_torch.export import PROB_Q_SCALE, make_resident_serve_fn
from dasmtl_torch.ops.decode import event_prob_q, event_prob_q_plain
from dasmtl_torch.ops.ring import ring_append, ring_append_plain
from dasmtl_torch.ops.window import window_gather, window_gather_plain
from dasmtl_torch.stream.feed import SyntheticSource
from dasmtl_torch.stream.live import StreamTenant
from dasmtl_torch.stream.resident import (ResidentFeed, build_lanes,
                                          next_pow2, pool_supports_resident,
                                          resident_rings_fit,
                                          resolve_resident_mode, rung_ladder)
from dasmtl_torch.stream.selftest import _oracle_pool
from dasmtl_torch.stream.windower import LiveWindower

WINDOW = (64, 64)
CPU = torch.device("cpu")


# -- kernel 3: the window gather ---------------------------------------------

@pytest.mark.parametrize("k", [1, 7, 32])
def test_window_gather_plain_matches_dynamic_slice(k):
    rng = np.random.default_rng(k)
    rec = rng.normal(size=(90, 700)).astype(np.float32)
    origins = np.stack([rng.integers(-20, 60, k),
                        rng.integers(-100, 800, k)], 1).astype(np.int32)
    origins[0] = (-3, 10_000)  # both axes out of range: clamped

    def cut(o):
        return jax.lax.dynamic_slice(jnp.asarray(rec), (o[0], o[1]),
                                     (52, 64))

    want = np.asarray(jax.vmap(cut)(jnp.asarray(origins)))[..., None]
    got = window_gather(torch.from_numpy(rec), torch.from_numpy(origins),
                        (52, 64))
    assert got.shape == (k, 52, 64, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_gather_refuses_a_window_larger_than_the_record():
    rec = torch.zeros(40, 100)
    with pytest.raises(ValueError, match="fit"):
        window_gather_plain(rec, torch.zeros(1, 2, dtype=torch.int32),
                            (52, 64))
    with pytest.raises(ValueError, match=r"\(k, 2\)"):
        window_gather(rec, torch.zeros(3, dtype=torch.int32), (4, 4))


# -- kernel 4: the ring append -----------------------------------------------

def test_ring_append_plain_matches_roll_and_update():
    rng = np.random.default_rng(1)
    ring = rng.normal(size=(6, 40)).astype(np.float32)
    chunk = rng.normal(size=(6, 9)).astype(np.float32)
    want = np.asarray(jax.lax.dynamic_update_slice(
        jnp.roll(jnp.asarray(ring), -9, axis=1), jnp.asarray(chunk),
        (0, 31)))
    got = ring_append_plain(torch.from_numpy(ring), torch.from_numpy(chunk))
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.empty(6, 40)
    assert ring_append(torch.from_numpy(ring), torch.from_numpy(chunk),
                       out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    with pytest.raises(ValueError, match="w_c"):
        ring_append_plain(torch.zeros(6, 8), torch.zeros(6, 9))


def test_resident_feed_matches_jax_over_ragged_appends():
    """50 ragged appends through both packages' ResidentFeed: the same
    ring, the same views, the same addressing and errors."""
    rng = np.random.default_rng(2)
    port = ResidentFeed(5, 96, chunk_samples=16)
    ref = JaxResidentFeed(5, 96, chunk_samples=16)
    port.warmup()
    ref.warmup()
    for i in range(50):
        piece = rng.normal(size=(5, int(rng.integers(0, 40)))
                           ).astype(np.float32)
        assert port.append(piece, now=float(i)) == ref.append(piece,
                                                              now=float(i))
        assert (port.total, port.pending, port.oldest, port.h2d_chunks) == \
            (ref.total, ref.pending, ref.oldest, ref.h2d_chunks)
        np.testing.assert_array_equal(port.ring.numpy(),
                                      np.asarray(ref.ring))
        if port.total >= 30:
            t0 = port.total - 30
            np.testing.assert_array_equal(port.view(t0, 30),
                                          ref.view(t0, 30))
            assert port.arrival_time(t0) == ref.arrival_time(t0)
    assert port.h2d_bytes == ref.h2d_bytes > 0
    for t0, n, match in ((port.oldest - 1, 8, "overwritten"),
                         (port.total - 4, 8, "not yet appended")):
        with pytest.raises(IndexError, match=match):
            port.check_window(t0, n)
        with pytest.raises(IndexError, match=match):
            ref.check_window(t0, n)


def test_resident_feed_matches_the_host_fiber_feed():
    host = JaxFiberFeed(4, 16)
    res = ResidentFeed(4, 16, chunk_samples=8)
    data = np.arange(4 * 40, dtype=np.float32).reshape(4, 40)
    for c0 in range(0, 40, 8):
        host.append(data[:, c0:c0 + 8], now=float(c0))
        res.append(data[:, c0:c0 + 8], now=float(c0))
    assert res.total == host.total == 40 and res.oldest == host.oldest
    np.testing.assert_array_equal(res.view(24, 16), host.view(24, 16))
    np.testing.assert_array_equal(res.view(30, 8), host.view(30, 8))


def test_resident_feed_warmup_leaves_an_all_zero_ring():
    feed = ResidentFeed(3, 32, chunk_samples=8)
    feed.append(np.ones((3, 16), np.float32))
    feed.warmup()
    assert not feed.ring.any() and not feed._spare.any()
    with pytest.raises(ValueError, match="chunk_samples"):
        ResidentFeed(3, 32, chunk_samples=33)


# -- kernel 5: event_prob_q ---------------------------------------------------

def test_event_prob_q_plain_matches_the_jax_formula():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(256, 2)) * 4).astype(np.float32)
    logits[:4] = [[0, 0], [3, -3], [-3, 3], [40, -40]]
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    want = np.asarray(jnp.round(jnp.exp(jnp.max(jnp.asarray(lp), axis=-1))
                                * JAX_PROB_Q_SCALE).astype(jnp.int32))
    got = event_prob_q(torch.from_numpy(lp))
    assert PROB_Q_SCALE == JAX_PROB_Q_SCALE and got.dtype == torch.int32
    assert np.abs(got.numpy() - want).max() <= 1
    assert got[0].item() == PROB_Q_SCALE // 2 and got[3] == PROB_Q_SCALE
    # Half-way ties round to even, as jnp.round does.
    ties = torch.log(torch.tensor([[0.5 + 0.5 / PROB_Q_SCALE],
                                   [0.5 + 1.5 / PROB_Q_SCALE]]))
    assert event_prob_q_plain(ties).tolist() == [
        int(np.round(np.exp(v) * PROB_Q_SCALE)) for v in
        ties.numpy()[:, 0]]


def test_resident_serve_fn_adds_event_prob_q_only_for_log_probs_event():
    """The reference's rule (``export.py:184-193``): ``event_prob_q`` only
    when the forward names a head ``log_probs_event``; ``bad_rows`` made
    when the forward lacks it."""
    rec = torch.from_numpy(np.random.default_rng(4).normal(
        size=(64, 200)).astype(np.float32))
    origins = torch.tensor([[0, 0], [0, 100]], dtype=torch.int32)
    oracle = make_resident_serve_fn(_oracle_pool(WINDOW, (1, 2), CPU)
                                    .raw_infer_fn, WINDOW)(rec, origins)
    assert oracle["event_prob_q"].dtype == torch.int32
    model_a = make_resident_serve_fn(
        lambda xs: {"distance": torch.zeros(xs.shape[0], dtype=torch.int32),
                    "log_probs_0": torch.zeros(xs.shape[0], 16)},
        WINDOW)(rec, origins)
    assert "event_prob_q" not in model_a
    assert model_a["bad_rows"].tolist() == [False, False]


# -- the window grid -----------------------------------------------------------

@pytest.mark.parametrize("shape,stride", [((60, 400), (0, 32)),
                                          ((130, 1000), (40, 125)),
                                          ((52, 64), (0, 0))])
def test_window_plan_and_index_batches_match_jax(shape, stride):
    window = (52, 64)
    stride = (stride[0] or window[0], stride[1] or window[1])
    ours = windowing.plan_windows(shape, window=window, stride=stride)
    ref = jax_windowing.plan_windows(shape, window=window, stride=stride)
    assert (ours.n_spatial, ours.n_temporal) == (ref.n_spatial,
                                                 ref.n_temporal)
    assert [ours.origin(i) for i in range(ours.n_windows)] == \
        [ref.origin(i) for i in range(ref.n_windows)]
    for pc in (1, 2):
        for pi in range(pc):
            a = list(windowing.window_index_batches(ours, 8, pi, pc))
            b = list(jax_windowing.window_index_batches(ref, 8, pi, pc))
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.keys() == y.keys()
                for key in x:
                    np.testing.assert_array_equal(x[key], y[key])
    rec = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    for x, y in zip(windowing.window_batches(rec, 8, ours),
                    jax_windowing.window_batches(rec, 8, ref)):
        for key in y:
            np.testing.assert_array_equal(x[key], y[key])


# -- the lane ------------------------------------------------------------------

def _fiber_data(seed=0, channels=64, samples=1024):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(channels, samples)) * 2.0).astype(np.float32)
    data[16:48, 320:832] *= 5.0
    return data


def test_rung_ladder_covers_power_of_two_dispatch_sizes():
    assert next_pow2(1) == 1 and next_pow2(5) == 8
    assert rung_ladder(8) == (1, 2, 4, 8) == rung_ladder(6)
    assert rung_ladder(1) == (1,)
    with pytest.raises(ValueError):
        rung_ladder(0)


def _tenant(seed):
    return StreamTenant(f"f{seed}", SyntheticSource(64, seed=seed),
                        window=WINDOW, stride_time=32, ring_samples=2048,
                        chunk_samples=64)


def test_oracle_resident_lane_matches_its_host_forward():
    """Every window of a planted stream through the fused gather +
    forward + decode dispatch equals the oracle on host-gathered pixels:
    ints and bools exactly, confidence and log-probs within 1e-6."""
    pool = _oracle_pool(WINDOW, (1, 2, 4, 8), CPU)
    (lane,) = build_lanes(pool, [_tenant(10)], max_windows=8)
    data = _fiber_data(seed=100)
    for c0 in range(0, data.shape[1], 64):
        lane.feed.append(data[:, c0:c0 + 64], now=float(c0))
    windower = LiveWindower(lane.feed, WINDOW, stride_time=32)
    n_checked = 0
    while True:
        cuts = windower.cut(8, pixels=False)
        if not cuts:
            break
        assert all(c.x is None for c in cuts)
        preds, bad, prob, log_probs = lane.executor.collect(
            lane.dispatch_windows(cuts), want_log_probs=True)
        xs = np.stack([data[c.c_origin:c.c_origin + 64,
                            c.t_origin:c.t_origin + 64] for c in cuts])
        host = {k: v.numpy() for k, v in
                pool.raw_infer_fn(torch.from_numpy(xs[..., None])).items()}
        np.testing.assert_array_equal(preds["event"], host["event"])
        np.testing.assert_array_equal(preds["distance"], host["distance"])
        np.testing.assert_array_equal(bad, host["bad_rows"])
        want_prob = np.exp(host["log_probs_event"].max(axis=-1))
        assert np.abs(prob - want_prob).max() <= 1e-6
        for key in ("log_probs_event", "log_probs_distance"):
            assert np.abs(log_probs[key] - host[key]).max() <= 1e-6
        n_checked += len(cuts)
    assert n_checked == 31 == lane.windows_dispatched
    assert len(set(np.unique(host["distance"]))) >= 1
    lane.close()


def test_dispatch_pads_to_the_rung_and_refuses_beyond_the_top():
    pool = _oracle_pool(WINDOW, (1, 2), CPU)
    (lane,) = build_lanes(pool, [_tenant(4)], max_windows=4)
    data = _fiber_data(seed=4)
    for c0 in range(0, 256, 64):
        lane.feed.append(data[:, c0:c0 + 64])
    cuts = LiveWindower(lane.feed, WINDOW, stride_time=32).cut(pixels=False)
    assert len(cuts) > 4
    batch = lane.dispatch_windows(cuts[:3])
    assert (batch.k, batch.rung) == (3, 4)
    preds, bad, prob, _ = lane.executor.collect(batch)
    assert preds["event"].shape == bad.shape == prob.shape == (3,)
    with pytest.raises(ValueError, match="top rung"):
        lane.dispatch_windows(cuts)
    with pytest.raises(IndexError, match="not yet appended"):
        lane.dispatch_windows([cuts[0].__class__(
            x=None, tile=0, c_origin=0, t_origin=lane.feed.total,
            t_end=lane.feed.total + 64, arrival_s=0.0)])
    lane.close()


def test_resolve_resident_mode_contract():
    import types

    pool = _oracle_pool(WINDOW, (1, 2), CPU)
    tenant = _tenant(5)
    assert pool_supports_resident(pool)
    assert resolve_resident_mode("off", pool, [tenant]) is False
    assert resolve_resident_mode("on", pool, [tenant]) is True
    # auto never engages on the CPU (the host path is as fast there).
    assert resolve_resident_mode("auto", pool, [tenant]) is False
    with pytest.raises(ValueError, match="unknown resident mode"):
        resolve_resident_mode("maybe", pool, [tenant])
    fixed = types.SimpleNamespace(raw_infer_fn=None, placement=CPU)
    assert not pool_supports_resident(fixed)
    with pytest.raises(ValueError, match="resident"):
        resolve_resident_mode("on", fixed, [tenant])
    assert resident_rings_fit([tenant])
    assert not resident_rings_fit([tenant], budget_bytes=1024)
