"""``python -m dasmtl_torch.serve`` — the port's online inference server.

Counterpart of ``python -m dasmtl.serve`` (``dasmtl/serve/__main__.py``)
for the serving slice: ``--fresh_init`` serves seed-deterministic
fresh-init weights of ``--model`` on ``--device`` (``cuda`` by default),
``POST /infer`` answers windows, ``GET /readyz`` is 503 until warmup has
run every bucket (the front end binds BEFORE warmup, so liveness answers
meanwhile), and SIGTERM drains: in-flight batches finish, new work gets an
explicit ``closed``, and the ``drained=... answered=... p50=... p99=...``
line goes to stderr.

``--model`` takes every family (model C is ``multi_classifier``) and
``--precision f32|bf16|int8`` every serving preset (:mod:`dasmtl_torch.
models.precision`).  ``--parity-check`` runs the precision gate instead of
serving (``dasmtl/serve/__main__.py:168-238``): the ``--precision`` preset,
or both reduced presets under ``f32``, against the f32 forward over a
seeded eval set (52x64 unless ``--window`` says otherwise); exit 0 when
every preset passes, 1 otherwise.  The JAX server's other model sources
exit with code 2 and name the ROADMAP.md item that brings them, and so do
the JAX server's flags this slice does not carry (:data:`JAX_ONLY_FLAGS`).
"""

from __future__ import annotations

import argparse
import sys
import threading

from dasmtl_torch import config as C

#: Options of ``python -m dasmtl.serve`` this slice does not port yet ->
#: the ROADMAP.md item that brings each.
_ARTIFACTS = "ROADMAP.md queue 1 item 5, 'Artifacts and registry'"
_POOL = "ROADMAP.md queue 1 item 4, 'Executor pool'"
_OBS = "ROADMAP.md queue 1 item 6, 'Observability endpoints and tracing'"
_ANALYSIS = ("ROADMAP.md queue 1 item 3 (the lint, audit, conc and mem "
             "families analyse JAX code and are not ported)")
NOT_YET_PORTED = {
    "model_path": f"{_ARTIFACTS} (the JAX checkpoints are Orbax files the "
                  f"port cannot read yet)",
    "exported": _ARTIFACTS,
    "registry": _ARTIFACTS,
}
#: Flags of ``python -m dasmtl.serve`` the port's parser does not declare,
#: by name prefix (``history`` is ``--history`` and ``--history_interval_s``)
#: -> the ROADMAP.md item that brings them.
JAX_ONLY_FLAGS = (
    ("devices", _POOL), ("shard_largest", _POOL),
    ("shard_multihost", _POOL),
    ("registry_version", _ARTIFACTS),
    ("trace_ring", _OBS), ("latency_buckets_ms", _OBS),
    ("profile_", _OBS), ("history", _OBS),
    ("conc_", _ANALYSIS), ("mem_", _ANALYSIS),
    ("selftest", f"{_POOL} (the serving soak, serve/selftest.py)"),
)


def _jax_only_item(arg: str):
    """The ROADMAP.md item of a JAX-only flag, or None."""
    if not arg.startswith("--"):
        return None
    name = arg[2:].split("=")[0]
    return next((item for flag, item in JAX_ONLY_FLAGS
                 if name.startswith(flag)), None)


def _parse_window(p: argparse.ArgumentParser, text: str):
    try:
        h, w = text.lower().split("x")
        return int(h), int(w)
    except ValueError:
        p.error(f"--window must look like 100x250, got {text!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="dasmtl_torch online inference serving: dynamic "
                    "micro-batching over a bucketed CUDA executor")
    src = p.add_argument_group("model source")
    src.add_argument("--fresh_init", action="store_true",
                     help="serve seed-deterministic fresh-init weights "
                          "(the only source this slice ports)")
    src.add_argument("--model_path", type=str, default=None,
                     help="not yet ported")
    src.add_argument("--exported", type=str, default=None,
                     help="not yet ported")
    src.add_argument("--registry", type=str, default=None,
                     help="not yet ported")
    p.add_argument("--model", type=str, default="MTL",
                   help="model family: MTL, single_distance, single_event, "
                        "multi_classifier")
    p.add_argument("--window", type=str, default=None, metavar="HxW",
                   help="window shape, e.g. 100x250 (default: "
                        f"{C.INPUT_HEIGHT}x{C.INPUT_WIDTH})")
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
    p.add_argument("--precision", type=str, default=C.SERVE_PRECISION,
                   choices=["f32", "bf16", "int8"],
                   help="serving precision preset")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--parity-check", action="store_true",
                   dest="parity_check",
                   help="run the precision parity gate instead of serving: "
                        "the --precision preset (both reduced presets "
                        "under f32) against the f32 forward over a seeded "
                        "eval set; exit 0/1")
    p.add_argument("--parity_windows", type=int, default=256,
                   help="eval-set size for --parity-check")
    p.add_argument("--parity_out", type=str, default=None, metavar="PATH",
                   help="also write the parity report section into PATH "
                        "(not docs/PARITY.md, the JAX package's)")
    args, extra = p.parse_known_args(argv)
    for arg in extra:
        item = _jax_only_item(arg)
        if item is not None:
            print(f"dasmtl_torch.serve: {arg.split('=')[0]} is not yet "
                  f"ported: {item}", file=sys.stderr)
            return 2
    if extra:
        p.error(f"unrecognized arguments: {' '.join(extra)}")

    for opt, item in NOT_YET_PORTED.items():
        if getattr(args, opt):
            print(f"dasmtl_torch.serve: --{opt} is not yet ported: {item}",
                  file=sys.stderr)
            return 2
    if args.parity_check:
        return _parity_check(p, args)
    if not args.fresh_init:
        p.error("--fresh_init is required (the only model source this "
                "slice ports)")
    try:
        buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    except ValueError:
        p.error(f"--buckets must be comma-separated ints, "
                f"got {args.buckets!r}")
    window = (_parse_window(p, args.window) if args.window
              else (C.INPUT_HEIGHT, C.INPUT_WIDTH))

    from dasmtl_torch.device import resolve_device
    from dasmtl_torch.serve.executor import InferExecutor
    from dasmtl_torch.serve.server import (ServeLoop,
                                           install_signal_handlers,
                                           make_http_server)

    device = resolve_device(args.device)
    try:
        executor = InferExecutor.from_fresh_init(args.model, buckets, window,
                                                 C.SEED, device,
                                                 args.precision)
    except (ValueError, NotImplementedError) as exc:
        # An unknown or not yet ported model family is an operational
        # error with a named fix, not a traceback.
        print(f"dasmtl_torch.serve: {exc}", file=sys.stderr)
        return 2
    loop = ServeLoop(executor, buckets=buckets,
                     max_wait_s=args.max_wait_ms / 1e3,
                     queue_depth=args.queue_depth,
                     watermark=args.watermark, inflight=args.inflight)
    # Bind the front end BEFORE warmup: /healthz answers while buckets
    # warm, /readyz stays 503 until every bucket has run.
    httpd = make_http_server(loop, args.host, args.port)
    host, port = httpd.server_address[:2]
    if args.port_file:
        with open(args.port_file, "w", encoding="utf-8") as f:
            f.write(f"{port}\n")
    stop = threading.Event()
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    print(f"warming {len(buckets)} bucket(s) {list(buckets)} on "
          f"{window[0]}x{window[1]} windows (precision {args.precision}) "
          f"on {device}; liveness already up on http://{host}:{port} ...",
          file=sys.stderr)
    loop.start()
    print(f"serving {executor.source} on http://{host}:{port} "
          f"(POST /infer, GET /healthz, GET /readyz, GET /stats); warmup "
          f"{loop.stats()['warmup_s']:.2f}s; in-flight window "
          f"{loop.inflight_window}; SIGTERM drains", file=sys.stderr)

    # SIGTERM/SIGINT: refuse new work, let the dispatcher finish what is
    # queued, then stop accepting connections.  shutdown() must not run in
    # the signal handler (it joins the serve_forever thread) — flag + poll.
    install_signal_handlers(loop, on_drain=lambda _s: stop.set())
    while not stop.wait(timeout=1.0):
        pass
    drained = loop.drain(timeout=60.0)
    httpd.shutdown()
    t.join(timeout=10.0)
    loop.close()
    stats = loop.stats()
    print(f"drained={'clean' if drained else 'TIMEOUT'} "
          f"answered={stats['requests']['answered']} "
          f"shed={stats['requests']['shed']} "
          f"p50={stats['latency_ms']['p50']}ms "
          f"p99={stats['latency_ms']['p99']}ms "
          f"occupancy={stats['batches']['mean_occupancy']:.2f}",
          file=sys.stderr)
    return 0 if drained else 1


def _parity_check(p: argparse.ArgumentParser, args) -> int:
    """``--parity-check``: gate the reduced presets on fresh-init weights
    of ``--model``; 0 when every preset passes."""
    from dasmtl_torch.device import card_label, resolve_device
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.serve.parity import run_parity, write_parity_report

    window = _parse_window(p, args.window) if args.window else (52, 64)
    resolve_device(args.device)  # raises without a card, naming --device cpu
    try:
        get_model_spec(args.model)
    except ValueError as exc:
        print(f"dasmtl_torch.serve: {exc}", file=sys.stderr)
        return 2
    presets = ([args.precision] if args.precision != "f32"
               else ["bf16", "int8"])
    reports = [run_parity(prec, model=args.model, input_hw=window,
                          n_windows=args.parity_windows,
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
