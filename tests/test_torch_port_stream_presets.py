"""The stream tier under the serving presets and for model C, on the CPU,
held to the JAX package.

- The bf16 ring: ``ring_append_plain`` on bf16 against JAX's roll +
  ``dynamic_update_slice``, and the port's ``ResidentFeed(dtype=bf16)``
  against JAX's ``ResidentFeed(dtype=ml_dtypes.bfloat16)`` over ragged
  appends with pending remainders: the same ring bits, ``total``,
  ``pending`` and ``h2d_bytes`` (bf16 bytes).  The bf16 gather:
  ``window_gather_plain`` against JAX's ``make_resident_forward`` with an
  identity body, negative and clamped origins included, bit for bit.  The
  kernels' plans by element size, and the wrappers' refusals (a tensor on
  a non-CPU device that the kernels do not take raises, nothing falls
  back).
- The resident serve forward of model A bf16 (52x64) and model C int8
  (75x75) over a bf16 ring against JAX's ``make_resident_serve_fn(
  make_precision_serve_fn(...))``, and ``StreamLoop`` over a synthetic
  fiber on both planes against JAX's, held by ``serve/parity.py:
  compare_runs`` at the committed preset tolerances (|dlog_prob| <= 0.05
  bf16, 0.10 int8), on the ``init_scaled`` weights the preset tests use
  (``tests/test_torch_port_precision.py``, ``..._inception.py``) carried
  to JAX with ``port_two_level_state_dict`` / ``port_inception_state_dict``.
  Int8 model C answers its NaN windows (``bad_rows`` False, confidence
  1.0) and they reach the track books, as in JAX.
- Model C's offline sweep on both planes and from a port artifact: rows
  equal to JAX's ``stream_predict`` on JAX's fresh init carried across; an
  int8 artifact's rows equal to JAX's int8 forward on decisive windows.
  ``--sanitize``: clean rows unchanged, a poisoned checkpoint and a
  poisoned artifact raising SAN202 with JAX's words.

Every test runs on one intra-op thread.
"""

import csv
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dasmtl.config import Config as JaxConfig
from dasmtl.export import make_resident_forward as jax_resident_forward
from dasmtl.export import make_resident_serve_fn as jax_resident_serve_fn
from dasmtl.main import build_state as jax_build_state
from dasmtl.models import precision as P
from dasmtl.models.registry import get_model_spec as jax_model_spec
from dasmtl.models.torch_port import (port_inception_state_dict,
                                      port_two_level_state_dict)
from dasmtl.serve.executor import InferExecutor as JaxInferExecutor
from dasmtl.serve.server import ServeLoop as JaxServeLoop
from dasmtl.stream import feed as jax_feed
from dasmtl.stream.live import StreamLoop as JaxStreamLoop
from dasmtl.stream.live import StreamTenant as JaxStreamTenant
from dasmtl.stream.offline import stream_predict as jax_stream_predict
from dasmtl.stream.resident import ResidentFeed as JaxResidentFeed
from dasmtl_torch.analysis.sanitize.common import NonFiniteError
from dasmtl_torch.data import matio
from dasmtl_torch.export import (export_infer, make_resident_serve_fn,
                                 transformed_serve_fn)
from dasmtl_torch.models import precision as TP
from dasmtl_torch.models.registry import get_model_spec
from dasmtl_torch.models.weights import (inception_state_dict_from_flax,
                                         init_scaled, state_dict_from_flax)
from dasmtl_torch.ops import ring as ops_ring
from dasmtl_torch.ops import window as ops_window
from dasmtl_torch.serve import parity
from dasmtl_torch.serve.executor import InferExecutor
from dasmtl_torch.serve.server import ServeLoop
from dasmtl_torch.stream import feed
from dasmtl_torch.stream.__main__ import main as stream_main
from dasmtl_torch.stream.live import (StreamLoop, StreamTenant,
                                      build_serve_parser, serve_executor)
from dasmtl_torch.stream.offline import stream_predict
from dasmtl_torch.stream.resident import ResidentFeed
from dasmtl_torch.train.checkpoint import CheckpointManager
from dasmtl_torch.train.optim import coupled_adam
from dasmtl_torch.train.state import TrainState

CPU = torch.device("cpu")
TOLERANCES = parity.LOG_PROB_TOLERANCES  # 0.05 bf16, 0.10 int8
#: The two presets of the slice: (family, precision, window,
#: init_scaled seed, weight bridge to Flax).
CONFIGS = {"A-bf16": ("MTL", "bf16", (52, 64), 3,
                      port_two_level_state_dict),
           "C-int8": ("multi_classifier", "int8", (75, 75), 9,
                      port_inception_state_dict)}
#: The JAX ServeLoop's one bucket: one compile of each forward.
BUCKET = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    """A bf16 array's (torch or JAX/ml_dtypes) 16-bit words."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _same_bits(got, want) -> None:
    """Equal bf16 words, but for the NaNs' payloads: the host casts of
    the two packages both give a quiet NaN for a NaN sample, torch's with
    every bit set (0xFFFF), ml_dtypes' keeping the f32's sign and top
    payload bits (0x7FC0 for ``np.nan``)."""
    g, w = _bits(got), _bits(want)
    nan_g = (g & 0x7F80) == 0x7F80
    nan_g &= (g & 0x007F) != 0
    nan_w = (w & 0x7F80) == 0x7F80
    nan_w &= (w & 0x007F) != 0
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(g[~nan_g], w[~nan_w])


# -- the bf16 ring and gather --------------------------------------------------

def test_bf16_ring_append_plain_matches_roll_and_update():
    rng = np.random.default_rng(1)
    ring = rng.normal(size=(6, 40)).astype(ml_dtypes.bfloat16)
    chunk = rng.normal(size=(6, 9)).astype(ml_dtypes.bfloat16)
    want = jax.lax.dynamic_update_slice(
        jnp.roll(jnp.asarray(ring), -9, axis=1), jnp.asarray(chunk), (0, 31))
    got = ops_ring.ring_append_plain(
        torch.from_numpy(ring.view(np.int16)).view(torch.bfloat16),
        torch.from_numpy(chunk.view(np.int16)).view(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("chunk_samples", [16, 125])
def test_bf16_resident_feed_matches_jax_over_ragged_appends(chunk_samples):
    """Ragged appends (pending remainders, several flushes in one call)
    through both packages' bf16 ResidentFeed: the same ring bits, views,
    addressing and H2D byte counts."""
    rng = np.random.default_rng(chunk_samples)
    port = ResidentFeed(5, 384, chunk_samples=chunk_samples,
                        dtype=torch.bfloat16)
    ref = JaxResidentFeed(5, 384, chunk_samples=chunk_samples,
                          dtype=ml_dtypes.bfloat16)
    port.warmup()
    ref.warmup()
    assert port.dtype == torch.bfloat16 and port.ring.dtype == torch.bfloat16
    for i in range(40):
        piece = (3.0 * rng.normal(size=(5, int(rng.integers(0, 300))))
                 ).astype(np.float32)
        assert port.append(piece, now=float(i)) == ref.append(piece,
                                                              now=float(i))
        assert (port.total, port.pending, port.oldest, port.h2d_chunks,
                port.h2d_bytes) == (ref.total, ref.pending, ref.oldest,
                                    ref.h2d_chunks, ref.h2d_bytes)
        np.testing.assert_array_equal(_bits(port.ring), _bits(ref.ring))
        if port.total >= 30:
            t0 = port.total - 30
            np.testing.assert_array_equal(
                port.view(t0, 30), np.asarray(ref.view(t0, 30), np.float32))
    assert port.h2d_bytes == 2 * 5 * chunk_samples * port.h2d_chunks > 0


@pytest.mark.parametrize("dtype", [torch.float16, np.float32])
def test_resident_feed_takes_the_kernels_dtypes_only(dtype):
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        ResidentFeed(3, 32, chunk_samples=8, dtype=dtype)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_bf16_window_gather_plain_matches_jax_dynamic_slice(k):
    rng = np.random.default_rng(k)
    rec = rng.normal(size=(90, 701)).astype(ml_dtypes.bfloat16)
    origins = np.stack([rng.integers(-20, 60, k),
                        rng.integers(-100, 800, k)], 1).astype(np.int32)
    origins[0] = (-3, 10_000)  # both axes: wrapped, then clamped
    want = jax.jit(jax_resident_forward(lambda xs: xs, (52, 64)))(
        jnp.asarray(rec), jnp.asarray(origins))
    got = ops_window.window_gather(
        torch.from_numpy(rec.view(np.int16)).view(torch.bfloat16),
        torch.from_numpy(origins), (52, 64))
    assert got.dtype == torch.bfloat16 and got.shape == (k, 52, 64, 1)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("T,ptr,elem,branch,rows", [
    (60000, 0, 4, "bulk", 4), (60000, 0, 2, "bulk", 4),
    (59996, 0, 4, "bulk", 4),    # T % 4 == 0: f32 rows are whole units
    (59996, 0, 2, "scalar", 4),  # ... but bf16 rows need T % 8 == 0
    (59999, 0, 2, "scalar", 4), (60000, 2, 2, "scalar", 4),
    (60000, 8, 2, "scalar", 4), (60000, 16, 2, "bulk", 4)])
def test_gather_plan_reasons_in_16_byte_units(T, ptr, elem, branch, rows):
    assert ops_window.gather_plan(T, ptr, 100, 250, 16, 132, elem) == \
        ops_window.GatherPlan(branch, rows)
    assert ops_window.gather_plan(T, ptr, 100, 250, 1, 132, elem).branch \
        == "rows"


def test_gather_plan_bf16_superset_takes_fewer_rows_only_when_wide():
    # round_up(w + 7, 8) bf16 words per row: 4 rows of two buffers fit
    # 96 KB up to w = 6137.
    assert ops_window.gather_plan(2 ** 16, 0, 64, 6136, 64, 132, 2) == \
        ops_window.GatherPlan("bulk", 4)
    assert ops_window.gather_plan(2 ** 16, 0, 64, 6145, 64, 132, 2) == \
        ops_window.GatherPlan("bulk", 2)
    with pytest.raises(ValueError, match="2 or 4 bytes"):
        ops_window.gather_plan(64, 0, 4, 4, 64, 132, 8)


@pytest.mark.parametrize("R,w_c,ptrs,vec", [
    (16384, 500, (0, 256, 512), 4),   # 1,000-byte shift: 8-byte units
    (16384, 1000, (0, 256, 512), 8),  # 2,000 bytes: 16-byte units
    (16384, 125, (0, 256, 512), 1), (16384, 250, (0, 256, 512), 2),
    (16384, 1000, (0, 8, 512), 4), (16384, 1000, (2, 256, 512), 1),
    (100, 1000 // 10, (0, 0, 0), 4)])
def test_ring_plan_follows_the_byte_offset(R, w_c, ptrs, vec):
    assert ops_ring.ring_plan(R, w_c, *ptrs) == vec


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """A tensor off the CPU goes to the kernel or raises: a dtype other
    than f32 / bf16, mixed dtypes, or a shape the kernel does not take
    raise before any launch (``meta`` tensors stand in for the card)."""
    meta = torch.device("meta")
    ring = torch.empty((4, 64), dtype=torch.bfloat16, device=meta)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops_ring.ring_append(ring.half(), torch.empty(
            (4, 8), dtype=torch.half, device=meta))
    with pytest.raises(TypeError, match="one dtype"):
        ops_ring.ring_append(ring, torch.empty((4, 8), device=meta))
    with pytest.raises(ValueError, match="w_c"):
        ops_ring.ring_append(ring, torch.empty(
            (4, 65), dtype=torch.bfloat16, device=meta))
    origins = torch.zeros((2, 2), dtype=torch.int32, device=meta)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops_window.window_gather(ring.half(), origins, (4, 8))
    with pytest.raises(TypeError, match="int32 origins"):
        ops_window.window_gather(ring, origins.long(), (4, 8))


# -- the presets: resident serve forward and the stream loop ------------------

@pytest.fixture(scope="module", params=list(CONFIGS))
def preset(request):
    """One preset of the slice: the port's weights, JAX's transformed
    serve forward (jitted once) and the port's serve forward."""
    family, prec, hw, seed, bridge = CONFIGS[request.param]
    spec = get_model_spec(family)
    sd = init_scaled(spec.build(), seed).state_dict()
    variables = bridge(sd)
    jax_fn, _ = P.make_precision_serve_fn(
        jax_model_spec(family),
        types.SimpleNamespace(params=variables["params"],
                              batch_stats=variables["batch_stats"]), prec)
    net = spec.build()
    net.load_state_dict(sd, strict=True)
    TP.apply_precision(net, prec)
    return types.SimpleNamespace(
        name=request.param, family=family, precision=prec, hw=hw, sd=sd,
        jax_fn=jax_fn, jax_jit=jax.jit(jax_fn),
        port_fn=transformed_serve_fn(spec, net, prec))


def _split(out):
    out = {k: np.asarray(v) for k, v in out.items()}
    out.pop("event_prob_q", None)
    bad = out.pop("bad_rows").astype(bool)
    lps = {k: out.pop(k) for k in list(out) if k.startswith("log_probs_")}
    return out, bad, lps


def _fiber(hw, nan=False):
    """A planted synthetic fiber of one tile (``hw[0]`` channels)."""
    return dict(channels=hw[0], seed=5, events=(
        (96, 256, 1, hw[0] // 2),), nan_samples=(200, 201) if nan else ())


def _source(pkg, spec):
    return pkg.SyntheticSource(
        spec["channels"], seed=spec["seed"],
        events=tuple(pkg.PlantedEvent(*e) for e in spec["events"]),
        nan_samples=spec["nan_samples"])


def test_resident_serve_forward_matches_jax(preset):
    """A bf16 ring filled by both packages' feeds, windows gathered at 4
    origins (one negative, one clamped), the preset's forward and the
    decode tail: JAX's fused program against the port's, at the preset's
    tolerance, ints equal on decisive rows, no ``event_prob_q``."""
    h, w = preset.hw
    # Standard-normal samples: the parity gate's evaluation distribution
    # (``parity.seeded_windows``), which the preset tolerances are for.
    data = np.random.default_rng(7).normal(size=(h + 8, 900)).astype(
        np.float32)
    data[3, 500] = np.nan  # one NaN window
    port_feed = ResidentFeed(h + 8, 1024, chunk_samples=100,
                             dtype=torch.bfloat16)
    jax_ring = JaxResidentFeed(h + 8, 1024, chunk_samples=100,
                               dtype=ml_dtypes.bfloat16)
    port_feed.append(data)
    jax_ring.append(data)
    _same_bits(port_feed.ring, jax_ring.ring)
    # Ring columns (sample + 124 once 900 samples are in): the last window
    # holds the NaN sample 500.
    origins = np.array([[0, 124], [-1, 300], [8, 2000], [2, 600]], np.int32)
    want = _split(jax.jit(jax_resident_serve_fn(preset.jax_fn, preset.hw))(
        jax_ring.ring, jnp.asarray(origins)))
    got = _split(make_resident_serve_fn(preset.port_fn, preset.hw)(
        port_feed.ring, torch.from_numpy(origins)))
    verdict = parity.compare_runs(want, got, want[1],
                                  precision=preset.precision)
    assert verdict["failures"] == []
    assert verdict["log_prob_max_abs_diff"] <= TOLERANCES[preset.precision]
    np.testing.assert_array_equal(got[1], want[1])
    # Model A bf16 rejects the NaN window; int8 model C answers it, as the
    # reference's int8_dot turns it finite.
    assert got[1].tolist() == ([False, False, False, True]
                               if preset.precision == "bf16"
                               else [False] * 4)


def _decodes(tenants):
    seen = []
    for t in tenants:
        update = t.book.update

        def spy(tile, d, now, update=update):
            seen.append((tile, d.t_origin, d.t_end, d.ok, d.event,
                         d.distance, d.event_prob))
            return update(tile, d, now)
        t.book.update = spy
    return seen


def _run_loop(serve, loop_cls, tenant_cls, pkg, hw, cycles=10, **kw):
    tenant = tenant_cls("f0", _source(pkg, _fiber(hw, nan=True)),
                        window=hw, stride_time=32, ring_samples=1024,
                        chunk_samples=64, open_windows=2, close_windows=2,
                        min_event_prob=0.5)
    stream = loop_cls(serve, [tenant], cycle_budget=BUCKET,
                      max_wait_s=0.002, clock=lambda: 0.0, **kw)
    seen = _decodes([tenant])
    try:
        for c in range(cycles):
            stream.run_cycle(now=float(c))
            import time
            deadline = time.monotonic() + 60.0
            while tenant.outstanding:
                assert time.monotonic() < deadline
                time.sleep(0.0005)
        assert stream.drain(timeout=30.0)
        return ([{k: v for k, v in r.items() if k != "t"}
                 for r in stream.events(10_000)], seen, tenant, stream)
    finally:
        stream.close()


def _window_log_probs(preset, keys, hw):
    """JAX's preset log-probs of the fiber's windows at ``keys``
    ``(t_origin, ...)`` (its bucket-4 program, padded)."""
    src = _source(jax_feed, _fiber(hw, nan=True))
    data = src.poll(max(d[1] for d in keys) + hw[1])
    xs = np.stack([data[:, d[1]:d[1] + hw[1]] for d in keys])[..., None]
    n = len(xs)
    xs = np.concatenate([xs, np.zeros((-n % BUCKET, *xs.shape[1:]),
                                      np.float32)])
    outs = [preset.jax_jit(xs[i:i + BUCKET].astype(ml_dtypes.bfloat16))
            for i in range(0, len(xs), BUCKET)]
    return {k: np.concatenate([np.asarray(o[k]) for o in outs])[:n]
            for k in outs[0] if k.startswith("log_probs_")}


def test_stream_loop_matches_jax_on_both_planes(preset):
    """A planted fiber (two NaN samples) through JAX's StreamLoop (host
    plane, its ServeLoop over the preset's executor) and the port's on
    both planes: every window resolves ok or rejected alike (int8 model C
    answers its NaN windows, with confidence 1.0, and they feed the
    books); ints equal on every window whose top-2 margin exceeds twice
    the preset's tolerance; the track records equal wherever every window
    of a track is decisive."""
    hw, prec = preset.hw, preset.precision
    jax_ex = JaxInferExecutor(preset.jax_fn, hw, (BUCKET,), precision=prec)
    jax_serve = JaxServeLoop(jax_ex, buckets=(BUCKET,), max_wait_s=0.002,
                             queue_depth=64)
    jax_serve.start()
    try:
        want, want_seen, jax_tenant, _ = _run_loop(
            jax_serve, JaxStreamLoop, JaxStreamTenant, jax_feed, hw)
    finally:
        jax_serve.drain(timeout=10.0)
        jax_serve.close()
    ex = InferExecutor.from_state_dict(preset.family, preset.sd, (BUCKET,),
                                       hw, CPU, prec)
    assert ex.input_dtype == torch.bfloat16
    port_serve = ServeLoop(ex, buckets=(BUCKET,), max_wait_s=0.002,
                           queue_depth=64).start()
    runs = {}
    try:
        for resident in ("off", "on"):
            runs[resident] = _run_loop(port_serve, StreamLoop, StreamTenant,
                                       feed, hw, resident=resident,
                                       resident_max_windows=BUCKET)
    finally:
        port_serve.close()
    lps = _window_log_probs(preset, want_seen, hw)
    heads = ({"event": "log_probs_1", "distance": "log_probs_0"}
             if preset.family == "MTL"
             else {"event": "log_probs_0", "distance": "log_probs_0"})

    def margin(lp):
        top2 = np.sort(lp, axis=1)[:, -2:]
        return top2[:, 1] - top2[:, 0]

    limit = 2 * TOLERANCES[prec]
    decisive = {task: margin(lps[head]) > limit
                for task, head in heads.items()}
    # A third at least (A bf16 16 / 19, C int8 7 / 18 on this fiber).
    assert all(3 * d.sum() >= len(want_seen) for d in decisive.values())
    nan_windows = [d for d in want_seen if 200 - hw[1] < d[1] <= 201]
    assert nan_windows
    indecisive = set()
    for resident, (records, seen, tenant, stream) in runs.items():
        assert stream.resident_enabled == (resident == "on")
        if resident == "on":
            lane = tenant.resident
            assert lane.feed.ring.dtype == torch.bfloat16
            assert lane.feed.h2d_bytes == \
                2 * hw[0] * 64 * lane.feed.h2d_chunks
        assert len(seen) == len(want_seen) == jax_tenant.resolved
        assert (tenant.submitted, tenant.resolved, tenant.rejected) == \
            (jax_tenant.submitted, jax_tenant.resolved, jax_tenant.rejected)
        for j, (g, w) in enumerate(zip(seen, want_seen)):
            assert g[:4] == w[:4] and g[6] == w[6] == \
                (1.0 if w[3] else 0.0), (resident, g, w)
            for i, task in ((4, "event"), (5, "distance")):
                if decisive[task][j] or not w[3]:
                    assert g[i] == w[i], (resident, task, g, w)
                else:
                    indecisive.add(w[1])
        whole = [r for r in want if not any(
            r["onset_sample"] <= t0 <= r["end_sample"] for t0 in indecisive)]
        got = [r for r in records if not any(
            r["onset_sample"] <= t0 <= r["end_sample"] for t0 in indecisive)]
        assert got == whole, resident
    # Model A bf16 rejects the NaN windows, int8 model C resolves them ok.
    assert all(d[3] == (prec == "int8") for d in nan_windows)
    assert want, "the planted event opened no track"


# -- model C's offline sweep ---------------------------------------------------

HW_C = (75, 75)


@pytest.fixture(scope="module")
def model_c_fresh(tmp_path_factory):
    """JAX's fresh init of model C (what ``stream_predict(model_path=
    None)`` builds) carried into a port checkpoint and a port f32
    artifact."""
    spec = jax_model_spec("multi_classifier")
    state = jax_build_state(JaxConfig(model="multi_classifier",
                                      batch_size=BUCKET), spec,
                            input_hw=HW_C)
    sd = inception_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}))
    net = get_model_spec("multi_classifier").build()
    net.load_state_dict(sd, strict=True)
    root = tmp_path_factory.mktemp("model_c")
    ckpt = CheckpointManager(str(root / "run")).save(
        TrainState(model=net, optimizer=coupled_adam(net.parameters())))
    art = root / "c-f32.torch"
    art.write_bytes(export_infer(get_model_spec("multi_classifier"), net,
                                 input_hw=HW_C))
    return net.eval(), ckpt, str(art), root


def _c_record(seed=0):
    return np.random.default_rng(seed).normal(size=(90, 400)).astype(
        np.float32)


def test_model_c_sweep_matches_jax_on_both_planes_and_from_an_artifact(
        model_c_fresh):
    net, ckpt, art, _ = model_c_fresh
    rec = _c_record()
    kw = dict(model="multi_classifier", batch_size=BUCKET, window=HW_C,
              stride=(0, 50))
    want = jax_stream_predict(rec, None, resident="off", **kw)
    runs = {r: stream_predict(rec, ckpt, resident=r, device="cpu", **kw)
            for r in ("on", "off")}
    runs["artifact"] = stream_predict(
        rec, None, device="cpu", exported_path=art, resident="auto",
        **{k: v for k, v in kw.items() if k != "window"})
    assert len(want) == 16 and list(want[0])[-2:] == ["pred_distance_m",
                                                      "pred_event"]
    # Decisive: the port's own f32 top-2 margin over DECISIVE.
    xs = np.stack([rec[r["channel_origin"]:r["channel_origin"] + 75,
                       r["time_origin"]:r["time_origin"] + 75]
                   for r in want])[..., None]
    with torch.inference_mode():
        lp = torch.log_softmax(net(torch.from_numpy(xs))[0], -1).numpy()
    top2 = np.sort(lp, axis=1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > 1e-3
    assert decisive.sum() >= 14
    for name, got in runs.items():
        assert [{k: v for k, v in r.items() if k.startswith(("window",
                 "channel", "time", "weight"))} for r in got] == \
            [{k: v for k, v in r.items() if k.startswith(("window",
              "channel", "time", "weight"))} for r in want], name
        for j in np.flatnonzero(decisive):
            assert got[j] == want[j], (name, j)
    assert runs["on"] == runs["off"]


def test_model_c_int8_artifact_sweep_matches_jax_s_int8_forward(tmp_path):
    """A port int8 artifact of model C (``init_scaled``, the preset
    tests' weights) swept from the CLI: each row's ints equal to JAX's
    int8 forward of the same window wherever its margin exceeds twice the
    int8 tolerance."""
    family, prec, hw, seed, bridge = CONFIGS["C-int8"]
    spec = get_model_spec(family)
    sd = init_scaled(spec.build(), seed).state_dict()
    net = spec.build()
    net.load_state_dict(sd, strict=True)
    art = tmp_path / "c-int8.torch"
    art.write_bytes(export_infer(spec, net, input_hw=hw, precision=prec))
    # Three times the unit scale: at unit scale these weights' 32-way
    # margins are 0.08-0.17, under twice the int8 tolerance.
    rec = 3.0 * _c_record(1)
    path = str(tmp_path / "rec.mat")
    matio.save_mat(path, rec)
    out = str(tmp_path / "rows.csv")
    assert stream_main(["--record", path, "--model", family, "--exported",
                        str(art), "--batch_size", str(BUCKET),
                        "--stride_time", "50", "--device", "cpu",
                        "--out", out]) == 0
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 16
    variables = bridge(sd)
    jax_fn, _ = P.make_precision_serve_fn(
        jax_model_spec(family), types.SimpleNamespace(
            params=variables["params"],
            batch_stats=variables["batch_stats"]), prec)
    xs = np.stack([rec[int(r["channel_origin"]):int(r["channel_origin"]) + 75,
                       int(r["time_origin"]):int(r["time_origin"]) + 75]
                   for r in rows])[..., None]
    want = {k: np.asarray(v) for k, v in jax.jit(jax_fn)(
        xs.astype(ml_dtypes.bfloat16)).items()}
    top2 = np.sort(want["log_probs_0"], axis=1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > 2 * TOLERANCES[prec]
    assert decisive.sum() >= 12
    for j in np.flatnonzero(decisive):
        assert int(rows[j]["pred_distance_m"]) == want["distance"][j]
        assert rows[j]["pred_event"] == ("striking", "excavating")[
            want["event"][j]]


# -- --sanitize ----------------------------------------------------------------

HW_A = (52, 64)


@pytest.fixture(scope="module")
def poisoned(tmp_path_factory):
    """JAX's fresh model A and its SAN202 fault (``faults.
    poison_param_nan``), each carried into a port checkpoint; and an
    artifact of the poisoned weights."""
    from dasmtl.analysis.sanitize import faults as jax_faults

    spec = jax_model_spec("MTL")
    state = jax_build_state(JaxConfig(model="MTL", batch_size=BUCKET), spec,
                            input_hw=HW_A)
    bad_state, _ = jax_faults.poison_param_nan(state)
    root = tmp_path_factory.mktemp("sanitize")
    out = {}
    for name, st in (("clean", state), ("bad", bad_state)):
        net = get_model_spec("MTL").build()
        net.load_state_dict(state_dict_from_flax(
            {"params": st.params, "batch_stats": st.batch_stats},
            ("distance", "event")), strict=True)
        out[name] = CheckpointManager(str(root / name)).save(
            TrainState(model=net, optimizer=coupled_adam(net.parameters())))
        if name == "bad":
            art = root / "bad.torch"
            art.write_bytes(export_infer(get_model_spec("MTL"), net,
                                         input_hw=HW_A))
            out["bad_artifact"] = str(art)
    out["jax_bad_state"] = bad_state
    out["root"] = root
    return out


def _a_record():
    return np.random.default_rng(5).normal(size=(52, 64 * 2 + 5))


@pytest.mark.parametrize("resident", ["on", "off"])
def test_sweep_sanitize_clean_rows_and_poisoned_catch(poisoned, resident):
    """JAX's ``test_stream_sanitize_clean_parity_and_poisoned_catch``
    (``tests/test_stream.py:264-290``) on the port, both planes: clean
    rows identical with the probe armed; the poisoned checkpoint sweeps
    unsanitized, and raises SAN202 with JAX's words when sanitized."""
    from dasmtl.analysis.sanitize.common import NonFiniteError as JaxError
    from dasmtl.train.checkpoint import CheckpointManager as JaxManager

    rec = _a_record()
    kw = dict(model="MTL", batch_size=BUCKET, window=HW_A, device="cpu",
              resident=resident)
    want = stream_predict(rec, poisoned["clean"], **kw)
    assert stream_predict(rec, poisoned["clean"], sanitize=True,
                          **kw) == want
    assert stream_predict(rec, poisoned["bad"], **kw)
    with pytest.raises(NonFiniteError, match="windows") as caught:
        stream_predict(rec, poisoned["bad"], sanitize=True, **kw)
    mgr = JaxManager(str(poisoned["root"] / f"jax-{resident}"))
    bad_ckpt = mgr.save(poisoned["jax_bad_state"])
    mgr.wait()
    with pytest.raises(JaxError) as jax_caught:
        jax_stream_predict(rec, bad_ckpt, model="MTL", batch_size=BUCKET,
                           window=HW_A, resident=resident, sanitize=True)
    assert str(caught.value) == str(jax_caught.value)
    assert str(caught.value).startswith(
        "SAN202: non-finite model outputs while streaming windows [0, 1, 2]")


def test_sweep_sanitize_on_an_artifact_and_from_the_cli(poisoned, tmp_path):
    """The ``--exported`` probe reads the artifact's ``bad_rows`` (JAX's
    ``nonfinite_rows``); the CLI takes ``--sanitize`` and, as JAX's,
    lets the SAN202 error end the run."""
    rec = _a_record()
    assert stream_predict(rec, None, model="MTL", batch_size=BUCKET,
                          device="cpu",
                          exported_path=poisoned["bad_artifact"])
    with pytest.raises(NonFiniteError) as caught:
        stream_predict(rec, None, model="MTL", batch_size=BUCKET,
                       device="cpu", exported_path=poisoned["bad_artifact"],
                       sanitize=True)
    assert str(caught.value) == (
        "SAN202: non-finite artifact outputs in 4 row(s) of this batch — "
        "the exported weights or the input record are poisoned")
    path = str(tmp_path / "rec.mat")
    matio.save_mat(path, rec)
    with pytest.raises(NonFiniteError, match="SAN202"):
        stream_main(["--record", path, "--model_path", poisoned["bad"],
                     "--batch_size", str(BUCKET), "--device", "cpu",
                     "--sanitize", "--out", str(tmp_path / "x.csv")])


def test_fused_flag_is_the_probe_s_answer_without_a_host_read():
    from dasmtl_torch.analysis.sanitize.fingerprint import (nonfinite_any,
                                                            nonfinite_flags)

    heads = [torch.zeros(3, 16), torch.zeros(3, 2)]
    (flag,) = nonfinite_flags(heads)
    assert isinstance(flag, torch.Tensor) and flag.dim() == 0 and not flag
    heads[1][2, 1] = float("inf")
    assert bool(nonfinite_flags(heads)[0]) and nonfinite_any(heads)
    assert nonfinite_flags([1.0, float("nan")]) == [True]


# -- the stream serve CLI under a preset ---------------------------------------

def test_serve_executor_hands_the_preset_to_every_source(tmp_path,
                                                         poisoned):
    """``--precision`` reaches the pool from ``--fresh_init``,
    ``--model_path`` and ``--exported``; an artifact of another preset is
    refused with the fix named, as JAX refuses it."""
    art = tmp_path / "a-bf16.torch"
    net = get_model_spec("MTL").build()
    art.write_bytes(export_infer(get_model_spec("MTL"), net, input_hw=HW_A,
                                 precision="bf16"))
    p = build_serve_parser()
    for source in (["--fresh_init"], ["--model_path", poisoned["clean"]],
                   ["--exported", str(art)]):
        for prec in ("bf16",) if source[0] == "--exported" else ("bf16",
                                                                 "int8"):
            args = p.parse_args([*source, "--precision", prec,
                                 "--synthetic", "1"])
            pool = serve_executor(args, (1, 2), HW_A, CPU)
            assert pool.precision == prec, (source, prec)
            assert pool.input_dtype == torch.bfloat16
    args = p.parse_args(["--exported", str(art), "--precision", "int8"])
    with pytest.raises(ValueError, match="precision 'bf16'.*--precision "
                                         "int8"):
        serve_executor(args, (1, 2), HW_A, CPU)


def test_int8_model_c_resident_lane_answers_nan_windows():
    """The resident lane of int8 model C on a fiber with NaN samples:
    every window decodes ``ok`` (``bad_rows`` False), as JAX's int8 model
    C answers them; the ring is bf16."""
    from dasmtl_torch.stream.resident import build_lanes
    from dasmtl_torch.stream.windower import LiveWindower

    ex = InferExecutor.from_state_dict(
        "multi_classifier", init_scaled(get_model_spec(
            "multi_classifier").build(), 9).state_dict(), (1, 2), HW_C, CPU,
        "int8")
    tenant = StreamTenant("f0", feed.SyntheticSource(75, seed=2,
                                                      nan_samples=(40,)),
                          window=HW_C, stride_time=25, ring_samples=512,
                          chunk_samples=50)
    (lane,) = build_lanes(ex, [tenant], max_windows=4)
    src = feed.SyntheticSource(75, seed=2, nan_samples=(40,))
    lane.feed.append(src.poll(200))
    cuts = LiveWindower(lane.feed, HW_C, stride_time=25).cut(
        4, pixels=False)
    preds, bad, prob, _ = lane.executor.collect(lane.dispatch_windows(cuts))
    assert [c.t_origin for c in cuts] == [0, 25, 50, 75]
    assert not bad.any() and set(prob) == {1.0}
    np.testing.assert_array_equal(preds["distance"], preds["mixed"] % 16)
    np.testing.assert_array_equal(preds["event"], preds["mixed"] // 16)
    lane.close()
