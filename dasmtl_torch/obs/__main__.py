"""``python -m dasmtl_torch obs`` (or ``python -m dasmtl_torch.obs``) —
the telemetry CLI, counterpart of ``dasmtl/obs/__main__.py`` with its
flags, messages (under this program's name) and exit codes.

Subcommands:

- ``dump``    — fetch span records from a live server's ``GET /trace``
  (or its ``/metrics`` text with ``--metrics``) and print them.
- ``capture`` — a ``torch.profiler`` trace of model A's train step
  (:func:`dasmtl_torch.obs.profiler.capture_main`).
- ``analyze`` — summarize a captured trace
  (:func:`dasmtl_torch.obs.profiler.analyze_main`).
- ``join``    — stitch router + replica ``/trace`` JSONL dumps (files or
  live URLs) into one end-to-end span chain per trace ID.
- ``check``   — ``monotone_regressions`` between two saved expositions;
  exit 1 on any regression, 2 when one cannot be parsed.
- ``selftest``— the alert-engine selftest.
"""

from __future__ import annotations

import argparse
import json
import sys


def _dump_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dasmtl_torch obs dump",
        description="dump span records (JSONL) or metrics from a live "
                    "dasmtl_torch.serve front end")
    ap.add_argument("--url", type=str, default="http://127.0.0.1:8321",
                    help="server base URL (python -m dasmtl_torch.serve --host/--port)")
    ap.add_argument("--n", type=int, default=None,
                    help="only the most recent N spans")
    ap.add_argument("--metrics", action="store_true",
                    help="fetch the Prometheus /metrics text instead of "
                         "/trace spans")
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)

    import urllib.error
    import urllib.request

    path = "/metrics" if args.metrics else "/trace"
    url = args.url.rstrip("/") + path
    if not args.metrics and args.n is not None:
        url += f"?n={args.n}"
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            sys.stdout.write(resp.read().decode("utf-8"))
    except (urllib.error.URLError, OSError) as exc:
        print(f"dasmtl_torch obs dump: cannot reach {url}: {exc}",
              file=sys.stderr)
        return 1
    return 0


def _read_spans(src: str, timeout: float) -> list:
    """Span dicts from a JSONL file, ``-`` (stdin), or a live base URL
    (its ``/trace`` endpoint)."""
    if src.startswith("http://") or src.startswith("https://"):
        import urllib.request

        url = src.rstrip("/")
        if not url.endswith("/trace"):
            url += "/trace"
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            text = resp.read().decode("utf-8")
    elif src == "-":
        text = sys.stdin.read()
    else:
        with open(src, encoding="utf-8") as fh:
            text = fh.read()
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def _join_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dasmtl_torch obs join",
        description="stitch router + replica /trace dumps into one "
                    "end-to-end span chain per trace ID")
    ap.add_argument("sources", nargs="+",
                    help="span JSONL files, '-' for stdin, or live base "
                         "URLs (their /trace is fetched)")
    ap.add_argument("--trace", type=str, default=None,
                    help="only this trace ID")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object per trace instead of the "
                         "human chain view")
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)

    from dasmtl_torch.obs.trace import join_chains

    spans = []
    for src in args.sources:
        try:
            spans.extend(_read_spans(src, args.timeout))
        except (OSError, ValueError) as exc:
            print(f"dasmtl_torch obs join: cannot read {src}: {exc}",
                  file=sys.stderr)
            return 1
    chains = join_chains(spans)
    if args.trace is not None:
        if args.trace not in chains:
            print(f"dasmtl_torch obs join: trace {args.trace!r} not found "
                  f"({len(chains)} traces in dump)", file=sys.stderr)
            return 1
        chains = {args.trace: chains[args.trace]}
    for trace_id in sorted(chains):
        chain = chains[trace_id]
        if args.json:
            print(json.dumps({"trace_id": trace_id, "spans": chain}))
            continue
        outcome = next((s["outcome"] for s in reversed(chain)
                        if s.get("outcome")), None)
        print(f"trace {trace_id}: {len(chain)} spans, "
              f"outcome={outcome or '?'}")
        for s in chain:
            where = s.get("device") or ""
            extras = " ".join(x for x in (
                f"bucket={s['bucket']}" if s.get("bucket") is not None
                else "",
                f"outcome={s['outcome']}" if s.get("outcome") else "",
                where and f"at={where}") if x)
            print(f"  {s['stage']:<14} start={s['start_s']:>12.6f}s "
                  f"dur={s['duration_s'] * 1e3:9.3f}ms  {extras}")
    return 0


def _check_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dasmtl_torch obs check",
        description="diff two saved Prometheus expositions; exit 1 when "
                    "any counter/histogram sample regressed (CI scrape "
                    "diffing)")
    ap.add_argument("before", help="earlier exposition text file")
    ap.add_argument("after", help="later exposition text file")
    args = ap.parse_args(argv)

    from dasmtl_torch.obs.registry import monotone_regressions, parse_exposition

    parsed = []
    for path in (args.before, args.after):
        try:
            with open(path, encoding="utf-8") as fh:
                parsed.append(parse_exposition(fh.read()))
        except (OSError, ValueError) as exc:
            print(f"dasmtl_torch obs check: cannot parse {path}: {exc}",
                  file=sys.stderr)
            return 2
    regressions = monotone_regressions(parsed[0], parsed[1])
    if regressions:
        print(f"dasmtl_torch obs check: {len(regressions)} monotonicity "
              f"regression(s) {args.before} -> {args.after}:")
        for line in regressions:
            print(f"  {line}")
        return 1
    n = sum(len(f["samples"]) for f in parsed[0].values())
    print(f"dasmtl_torch obs check: OK — {n} samples, no counter went "
          f"backwards")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {
        "dump": (_dump_main, "dump /trace spans (or --metrics) from a "
                             "live server"),
        "capture": (None, "capture a torch.profiler trace of the train "
                          "step"),
        "analyze": (None, "summarize a captured trace"),
        "join": (_join_main, "stitch router + replica /trace dumps into "
                             "end-to-end chains"),
        "check": (_check_main, "diff two saved expositions; exit 1 on "
                               "counter regressions"),
        "selftest": (None, "alert-engine selftest (CI-gated)"),
    }
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m dasmtl_torch obs <command> [args...]\n\n"
              "commands:")
        for name, (_, help_text) in commands.items():
            print(f"  {name:<8} {help_text}")
        return 0 if argv else 2
    cmd = argv.pop(0)
    if cmd == "dump":
        return _dump_main(argv)
    if cmd == "join":
        return _join_main(argv)
    if cmd == "check":
        return _check_main(argv)
    if cmd == "selftest":
        from dasmtl_torch.obs.alerts import run_alert_selftest

        return run_alert_selftest()
    if cmd == "capture":
        from dasmtl_torch.obs.profiler import capture_main

        return capture_main(argv)
    if cmd == "analyze":
        from dasmtl_torch.obs.profiler import analyze_main

        return analyze_main(argv)
    print(f"dasmtl_torch obs: unknown command {cmd!r} "
          f"(choose from {', '.join(commands)})", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
