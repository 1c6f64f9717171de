"""``python -m dasmtl_torch.serve`` — the port's online inference server.

Counterpart of ``python -m dasmtl.serve`` (``dasmtl/serve/__main__.py``).
Exactly one model source: ``--model_path`` (a port checkpoint, as ``test``
restores it), ``--exported`` (a port artifact of ``python -m
dasmtl_torch.export``), ``--registry DIR [--registry_version N|latest]``
(a versioned artifact registry) or ``--fresh_init`` (seed-deterministic
fresh-init weights of ``--model``).  The server runs on ``--device``
(``cuda`` by default), ``POST /infer`` answers windows, ``GET /readyz`` is
503 until warmup has run every bucket (the front end binds BEFORE warmup,
so liveness answers meanwhile), ``POST /swap {"version": ...}`` rebuilds
the executor through the same builder as startup (a registry replica
re-resolves, a checkpoint replica re-reads its weights) and flips to it
blue/green, and SIGTERM drains: in-flight batches finish, new work gets an
explicit ``closed``, and the ``drained=... answered=... p50=... p99=...``
line goes to stderr.

``--model`` takes every family (model C is ``multi_classifier``) and
``--precision f32|bf16|int8`` every serving preset (:mod:`dasmtl_torch.
models.precision`); an artifact's header must agree with it.
``--devices N`` (-1, the default: every visible card) serves from an
executor pool, one warmed CUDA graph per (bucket, device), batches
round-robin; ``--shard_largest`` splits a largest-bucket batch into one row
block per member; ``--selftest`` runs the serving soak instead of serving
(``--selftest_requests``, ``--selftest_clients``, ``--selftest_devices``;
exit 0 when it passed; its invariant 6 scrapes ``/metrics`` over a real
front end and fires one SLO capture).  Observability (JAX ``dasmtl/serve/
__main__.py:107-135``, ``:317-398``): ``GET /metrics``, ``GET /trace``
(``--trace_ring``, 0 disables), ``GET /query`` (``--history`` snapshots
every ``--history_interval_s``, 0 disables), ``POST /profile`` and SIGUSR2
(a ``torch.profiler`` Chrome trace of ``--profile_duration_s`` into
``--profile_dir``, at most one per ``--profile_cooldown_s``, and one when
p99 crosses ``--slo_p99_ms``), ``X-Dasmtl-Trace`` adopted and echoed.
``--parity-check`` runs the precision gate instead of serving
(``dasmtl/serve/__main__.py:168-238``): the ``--precision`` preset, or
both reduced presets under ``f32``, against the f32 forward over a seeded
eval set (52x64 unless ``--window`` says otherwise), on the weights of
``--model_path`` or the fresh init; exit 0 when every preset passes, 1
otherwise.  The JAX server's flags this port does not carry yet exit with
code 2 and name the ROADMAP.md item that brings them
(:data:`JAX_ONLY_FLAGS`).
"""

from __future__ import annotations

import argparse
import sys
import threading

from dasmtl_torch import config as C

_POOL = "ROADMAP.md queue 1 item 4, 'Executor pool'"
_ANALYSIS = ("ROADMAP.md queue 1 item 3 (the lint, audit, conc and mem "
             "families analyse JAX code and are not ported)")
#: Flags of ``python -m dasmtl.serve`` the port's parser does not declare,
#: by name prefix -> the ROADMAP.md item that brings them.
JAX_ONLY_FLAGS = (
    ("shard_multihost", f"{_POOL} (serving ranks on separate hosts)"),
    ("conc_", _ANALYSIS), ("mem_", _ANALYSIS),
)


def _jax_only_item(arg: str, flags=JAX_ONLY_FLAGS):
    """The ROADMAP.md item of a JAX-only flag (``flags``: name prefix ->
    item), or None."""
    if not arg.startswith("--"):
        return None
    name = arg[2:].split("=")[0]
    return next((item for flag, item in flags
                 if name.startswith(flag)), None)


def _parse_window(p: argparse.ArgumentParser, text: str):
    try:
        h, w = text.lower().split("x")
        return int(h), int(w)
    except ValueError:
        p.error(f"--window must look like 100x250, got {text!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dasmtl_torch.serve",
        description="dasmtl_torch online inference serving: dynamic "
                    "micro-batching over a bucketed CUDA executor")
    src = p.add_argument_group("model source (exactly one)")
    src.add_argument("--model_path", type=str, default=None,
                     help="port checkpoint dir (ckpts/step_<n> or best)")
    src.add_argument("--exported", type=str, default=None,
                     help="port artifact (python -m dasmtl_torch.export); "
                          "its header's window and precision must agree "
                          "with --window / --precision")
    src.add_argument("--fresh_init", action="store_true",
                     help="serve seed-deterministic fresh-init weights")
    src.add_argument("--registry", type=str, default=None, metavar="DIR",
                     help="serve from a versioned artifact registry "
                          "(python -m dasmtl_torch.export --registry "
                          "publishes into one); POST /swap re-resolves")
    p.add_argument("--registry_version", type=str, default="latest",
                   help="registry version to load at startup (an int or "
                        "'latest')")
    p.add_argument("--model", type=str, default="MTL",
                   help="model family: MTL, single_distance, single_event, "
                        "multi_classifier (an artifact names its own)")
    p.add_argument("--window", type=str, default=None, metavar="HxW",
                   help="window shape, e.g. 100x250 (default: "
                        f"{C.INPUT_HEIGHT}x{C.INPUT_WIDTH}; an artifact's "
                        "own with --exported / --registry)")
    p.add_argument("--buckets", type=str,
                   default=",".join(str(b) for b in C.SERVE_BUCKETS),
                   help="comma-separated batch-shape ladder run at warmup; "
                        "every served batch pads to one of these")
    p.add_argument("--max_wait_ms", type=float, default=C.SERVE_MAX_WAIT_MS,
                   help="micro-batching deadline: longest a request waits "
                        "for peers before its batch flushes")
    p.add_argument("--queue_depth", type=int, default=C.SERVE_QUEUE_DEPTH,
                   help="hard bound on queued requests")
    p.add_argument("--watermark", type=int, default=None,
                   help="shed arrivals beyond this many queued requests "
                        "(default: 90%% of --queue_depth)")
    p.add_argument("--host", type=str, default=C.SERVE_HOST)
    p.add_argument("--port", type=int, default=C.SERVE_PORT)
    p.add_argument("--port_file", type=str, default=None, metavar="PATH",
                   help="write the bound port here once the front end is "
                        "listening (--port 0 = ephemeral)")
    p.add_argument("--inflight", type=int, default=C.SERVE_INFLIGHT,
                   help="pipeline depth: batches dispatched but not yet "
                        "collected")
    p.add_argument("--devices", type=int, default=C.SERVE_DEVICES,
                   help="executor-pool size (-1 = every visible card); "
                        "batches round-robin over one warmed CUDA graph "
                        "per (bucket, device)")
    p.add_argument("--shard_largest", action="store_true",
                   default=C.SERVE_SHARD_LARGEST,
                   help="split largest-bucket batches into one row block "
                        "per pool device instead of running them on one")
    p.add_argument("--precision", type=str, default=C.SERVE_PRECISION,
                   choices=["f32", "bf16", "int8"],
                   help="serving precision preset; with --exported or "
                        "--registry the artifact's header must agree")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--parity-check", action="store_true",
                   dest="parity_check",
                   help="run the precision parity gate instead of serving: "
                        "the --precision preset (both reduced presets "
                        "under f32) against the f32 forward over a seeded "
                        "eval set, on --model_path's weights or the fresh "
                        "init; exit 0/1")
    p.add_argument("--parity_windows", type=int, default=256,
                   help="eval-set size for --parity-check")
    p.add_argument("--parity_out", type=str, default=None, metavar="PATH",
                   help="also write the parity report section into PATH "
                        "(not docs/PARITY.md, the JAX package's)")
    p.add_argument("--selftest", action="store_true",
                   help="run the in-process serving soak (concurrent "
                        "clients, NaN poisoning, SIGTERM drain) and exit "
                        "0/1 — no network")
    p.add_argument("--selftest_requests", type=int, default=512)
    p.add_argument("--selftest_clients", type=int, default=8)
    p.add_argument("--selftest_devices", type=int, default=1,
                   help="executor-pool size for the selftest")
    obs = p.add_argument_group("observability (dasmtl_torch/obs/)")
    obs.add_argument("--trace_ring", type=int, default=C.OBS_TRACE_RING,
                     help="request-span ring capacity behind GET /trace "
                          "(0 disables tracing)")
    obs.add_argument("--latency_buckets_ms", type=str,
                     default=",".join(f"{b:g}"
                                      for b in C.OBS_LATENCY_BUCKETS_MS),
                     help="latency histogram bucket bounds (ms, "
                          "ascending) exported at GET /metrics")
    obs.add_argument("--slo_p99_ms", type=float, default=C.OBS_SLO_P99_MS,
                     help="p99 latency SLO (ms): a breach captures ONE "
                          "rate-limited torch.profiler trace (0 disables)")
    obs.add_argument("--profile_dir", type=str, default=C.OBS_PROFILE_DIR,
                     help="where profiler captures land (POST /profile, "
                          "SIGUSR2, or an SLO breach)")
    obs.add_argument("--profile_cooldown_s", type=float,
                     default=C.OBS_PROFILE_COOLDOWN_S,
                     help="minimum seconds between profiler captures")
    obs.add_argument("--profile_duration_s", type=float,
                     default=C.OBS_PROFILE_DURATION_S,
                     help="seconds each capture records")
    obs.add_argument("--history", type=int, default=C.OBS_HISTORY,
                     help="metrics-history snapshots kept behind "
                          "GET /query (0 disables)")
    obs.add_argument("--history_interval_s", type=float,
                     default=C.OBS_HISTORY_INTERVAL_S,
                     help="seconds between history snapshots")
    return p


def executor_builder(args, buckets, window, device):
    """``build(version=None) -> ExecutorPool`` for the model source of
    ``args`` over ``--devices`` (``--shard_largest``): the one builder of
    startup and of every ``POST /swap`` (``dasmtl/serve/__main__.py:
    275-310``).  A registry builder resolves ``version``
    (``--registry_version`` at startup), a checkpoint builder re-reads its
    weights, an artifact builder re-reads its file; each artifact is
    checked against ``window`` (None: the artifact's own) and
    ``--precision``."""
    from dasmtl_torch.serve.executor import ExecutorPool

    hw = window or (C.INPUT_HEIGHT, C.INPUT_WIDTH)
    pool_kw = dict(devices=args.devices, shard_largest=args.shard_largest)
    if args.exported:
        def build(version=None):
            return ExecutorPool.from_exported(
                args.exported, buckets, expected_hw=window, device=device,
                precision=args.precision, **pool_kw)
    elif args.registry:
        from dasmtl_torch.export import ArtifactRegistry

        registry = ArtifactRegistry(args.registry)

        def build(version=None):
            entry = registry.resolve(version if version is not None
                                     else args.registry_version)
            print(f"dasmtl_torch.serve: registry {args.registry} -> "
                  f"v{entry['version']} ({entry['file']})", file=sys.stderr)
            return ExecutorPool.from_exported(
                entry["path"], buckets, expected_hw=window, device=device,
                precision=args.precision, **pool_kw)
    elif args.model_path:
        def build(version=None):
            return ExecutorPool.from_checkpoint(
                args.model, args.model_path, buckets, hw, device,
                args.precision, **pool_kw)
    else:
        def build(version=None):
            return ExecutorPool.from_fresh_init(
                args.model, buckets, hw, C.SEED, device, args.precision,
                **pool_kw)
    return build


def main(argv=None) -> int:
    p = build_parser()
    args, extra = p.parse_known_args(argv)
    for arg in extra:
        item = _jax_only_item(arg)
        if item is not None:
            print(f"dasmtl_torch.serve: {arg.split('=')[0]} is not yet "
                  f"ported: {item}", file=sys.stderr)
            return 2
    if extra:
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    try:
        latency_buckets_s = C.check_obs_flags(
            trace_ring=args.trace_ring,
            latency_buckets_ms=args.latency_buckets_ms,
            slo_p99_ms=args.slo_p99_ms,
            profile_cooldown_s=args.profile_cooldown_s,
            profile_duration_s=args.profile_duration_s,
            history=args.history,
            history_interval_s=args.history_interval_s)
    except ValueError as exc:
        p.error(str(exc))
    if args.selftest:
        return _selftest(args)
    if args.parity_check:
        return _parity_check(p, args)
    n_sources = sum(1 for v in (args.exported, args.model_path,
                                args.fresh_init, args.registry) if v)
    if n_sources != 1:
        p.error("exactly one of --exported / --model_path / --fresh_init "
                "/ --registry is required")
    try:
        buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    except ValueError:
        p.error(f"--buckets must be comma-separated ints, "
                f"got {args.buckets!r}")
    window = _parse_window(p, args.window) if args.window else None

    from dasmtl_torch.device import resolve_device
    from dasmtl_torch.obs.profiler import ProfilerHook
    from dasmtl_torch.serve.server import (ServeLoop,
                                           install_signal_handlers,
                                           make_http_server)

    device = resolve_device(args.device)
    build_executor = executor_builder(args, buckets, window, device)
    try:
        executor = build_executor()
    except (ValueError, NotImplementedError, OSError) as exc:
        # A missing file, an unknown family, or a window / precision /
        # registry disagreement is an operational error with a named fix,
        # not a traceback.
        print(f"dasmtl_torch.serve: {exc}", file=sys.stderr)
        return 2
    profiler = ProfilerHook(args.profile_dir,
                            cooldown_s=args.profile_cooldown_s,
                            duration_s=args.profile_duration_s)
    # SIGUSR2 = "profile this server NOW" (still rate-limited); POST
    # /profile and the SLO breach path share the same hook, brought up
    # here so a capture records from its trigger on.
    profiler.arm_signal()
    profiler.prime()
    loop = ServeLoop(executor, buckets=buckets,
                     max_wait_s=args.max_wait_ms / 1e3,
                     queue_depth=args.queue_depth,
                     watermark=args.watermark, inflight=args.inflight,
                     trace_ring=args.trace_ring,
                     latency_buckets_s=latency_buckets_s,
                     slo_p99_ms=args.slo_p99_ms, profiler=profiler)
    history = sampler = None
    if args.history > 0:
        from dasmtl_torch.obs.history import HistorySampler, MetricsHistory

        history = MetricsHistory(args.history)
        sampler = HistorySampler(history, loop.metrics_text,
                                 interval_s=args.history_interval_s)
        sampler.start()
    # Bind the front end BEFORE warmup: /healthz answers while buckets
    # warm, /readyz stays 503 until every bucket has run.
    httpd = make_http_server(loop, args.host, args.port,
                             swap_builder=build_executor, history=history)
    host, port = httpd.server_address[:2]
    if args.port_file:
        with open(args.port_file, "w", encoding="utf-8") as f:
            f.write(f"{port}\n")
    stop = threading.Event()
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    h, w = executor.input_hw
    print(f"warming {len(buckets)} bucket(s) {list(buckets)} on "
          f"{h}x{w} windows (precision {executor.precision}) on a pool of "
          f"{len(executor.executors)} ({', '.join(map(str, executor.devices))}"
          f"{'; largest bucket sharded' if executor.shard_executor else ''}"
          f"); liveness already up on http://{host}:{port} ...",
          file=sys.stderr)
    loop.start()
    print(f"serving {executor.source} on http://{host}:{port} "
          f"(POST /infer, GET /healthz, GET /readyz, GET /stats, "
          f"GET /metrics, GET /trace"
          + (", GET /query" if history is not None else "")
          + f", POST /swap, POST /profile); warmup "
          f"{loop.stats()['warmup_s']:.2f}s; in-flight window "
          f"{loop.inflight_window}; SIGTERM drains; SIGUSR2 profiles",
          file=sys.stderr)

    # SIGTERM/SIGINT: refuse new work, let the dispatcher finish what is
    # queued, then stop accepting connections.  shutdown() must not run in
    # the signal handler (it joins the serve_forever thread) — flag + poll.
    install_signal_handlers(loop, on_drain=lambda _s: stop.set())
    while not stop.wait(timeout=1.0):
        pass
    drained = loop.drain(timeout=60.0)
    if sampler is not None:
        sampler.stop()
    httpd.shutdown()
    t.join(timeout=10.0)
    loop.close()
    # An in-flight capture finishes (the profiler stops and writes its
    # trace) before the interpreter exits.
    profiler.wait(timeout=args.profile_duration_s + 30.0)
    stats = loop.stats()
    print(f"drained={'clean' if drained else 'TIMEOUT'} "
          f"answered={stats['requests']['answered']} "
          f"shed={stats['requests']['shed']} "
          f"p50={stats['latency_ms']['p50']}ms "
          f"p99={stats['latency_ms']['p99']}ms "
          f"occupancy={stats['batches']['mean_occupancy']:.2f} "
          f"generation={loop.generation}", file=sys.stderr)
    return 0 if drained else 1


def _selftest(args) -> int:
    """``--selftest``: the serving soak (:func:`dasmtl_torch.serve.
    selftest.run_selftest`) on ``--device``; 0 when it passed."""
    from dasmtl_torch.device import resolve_device
    from dasmtl_torch.serve.selftest import run_selftest, write_job_summary

    report = run_selftest(requests=args.selftest_requests,
                          clients=args.selftest_clients,
                          devices=args.selftest_devices,
                          inflight=args.inflight, precision=args.precision,
                          device=resolve_device(args.device))
    write_job_summary(report)
    return 0 if report["passed"] else 1


def _parity_check(p: argparse.ArgumentParser, args) -> int:
    """``--parity-check``: gate the reduced presets on the weights of
    ``--model_path`` (fresh-init weights of ``--model`` without it); 0
    when every preset passes."""
    from dasmtl_torch.device import card_label, resolve_device
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.serve.parity import run_parity, write_parity_report
    from dasmtl_torch.train.checkpoint import checkpoint_weights

    window = _parse_window(p, args.window) if args.window else (52, 64)
    resolve_device(args.device)  # raises without a card, naming --device cpu
    try:
        get_model_spec(args.model)
        weights = (checkpoint_weights(args.model_path) if args.model_path
                   else None)
    except (ValueError, OSError) as exc:
        print(f"dasmtl_torch.serve: {exc}", file=sys.stderr)
        return 2
    presets = ([args.precision] if args.precision != "f32"
               else ["bf16", "int8"])
    reports = [run_parity(prec, model=args.model, state_dict=weights,
                          input_hw=window, n_windows=args.parity_windows,
                          device=args.device, verbose=True)
               for prec in presets]
    if args.parity_out:
        where = card_label() if args.device == "cuda" else "cpu"
        write_parity_report(
            reports, args.parity_out,
            context={"device": where, "window": f"{window[0]}x{window[1]}",
                     "eval set": f"{args.parity_windows} seeded windows "
                                 f"(seed 0, every 17th NaN-poisoned)"})
        print(f"parity report written to {args.parity_out}",
              file=sys.stderr)
    return 0 if all(r.passed for r in reports) else 1


if __name__ == "__main__":
    sys.exit(main())
