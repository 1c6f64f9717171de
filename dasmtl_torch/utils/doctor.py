"""Environment diagnostics — ``python -m dasmtl_torch doctor``.

Counterpart of ``dasmtl/utils/doctor.py``: one page answering "why is my
run slow, or on the wrong device, or reading with scipy?" — the CUDA card
(name, capability, power limit), the hand-written kernel library (its
path under ``build/dasmtl_torch/``, whether it is built, its ``sm_90a``
flags, the builds and graph captures this process ran), the native MAT
reader and the reader a run would resolve to, the defaults of the perf,
loader, serve, router, stream, obs, guard and sanitize flags, the
artifact registry and the determinism baseline's status.

What exists only on the TPU or JAX side is left out: the TPU tunnel
probe, the evidence-round tag, XLA's compilation cache, the lint rules,
and the conc, mem, audit and surface baselines (their families analyse
JAX code and are not ported).  Without a card it reports ``backend:
UNAVAILABLE — <reason>`` and computes nothing on the CPU.

``--json`` prints one machine-readable line instead of the report; the
exit code is 1 only when ``--exported`` is not ``compatible``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys
from typing import Optional


def collect() -> dict:
    import torch

    info: dict = {"python": sys.version.split()[0], "versions": {}}
    for mod in ("torch", "numpy", "scipy"):
        try:
            m = importlib.import_module(mod)
            info["versions"][mod] = getattr(m, "__version__", "?")
        except ImportError:  # a missing dependency is data
            info["versions"][mod] = None
    info["versions"]["torch cuda"] = torch.version.cuda or "none (CPU " \
                                                          "build)"
    info["env"] = {k: v for k, v in os.environ.items()
                   if k in ("CUDA_VISIBLE_DEVICES", "CUDA_HOME",
                            "TEARDOWN_CUPTI", "OMP_NUM_THREADS")}

    if torch.cuda.is_available():
        info["backend"] = "cuda"
        n = torch.cuda.device_count()
        info["device_count"] = n
        info["devices"] = [torch.cuda.get_device_name(i) for i in range(n)]
        info["device_kind"] = info["devices"][0]
        info["capability"] = list(torch.cuda.get_device_capability(0))
        info["power_limit"] = _nvidia_smi_power()
    else:
        info["backend"] = None
        info["backend_error"] = (
            "torch.cuda.is_available() is False (no CUDA device or a "
            "CPU-only torch build); the port's entry points need --device "
            "cpu here")

    info["kernel_library"] = _kernel_library()

    from dasmtl_torch.data import native

    info["native_loader"] = {"available": native.available(),
                             "library": native.status(),
                             "path": str(native.library_path())}

    from dasmtl_torch.config import Config, serve_watermark

    d = Config()
    info["perf_defaults"] = {
        "compute_dtype": d.compute_dtype,
        "device_data": d.device_data,
        "steps_per_dispatch": d.steps_per_dispatch,
        "prefetch_batches": d.prefetch_batches,
        "bn_sync": d.bn_sync,
        "dp": d.dp,
    }
    info["loader"] = {
        "workers": d.loader_workers,
        "queue_depth": d.loader_queue_depth,
        "native_mode": d.loader_native,
        "native_resolved": "native" if (
            d.loader_native != "off" and info["native_loader"]["available"]
        ) else "scipy-fallback",
    }
    info["serve_defaults"] = {
        "buckets": list(d.serve_buckets),
        "max_wait_ms": d.serve_max_wait_ms,
        "queue_depth": d.serve_queue_depth,
        "watermark": serve_watermark(d.serve_buckets, d.serve_queue_depth,
                                     d.serve_watermark),
        "endpoint": f"{d.serve_host}:{d.serve_port}",
        "inflight": d.serve_inflight,
        "devices": d.serve_devices,
        "shard_largest": d.serve_shard_largest,
        "precision": d.serve_precision,
    }
    info["router_defaults"] = {
        "replicas": d.router_replicas,
        "endpoint": f"{d.router_host}:{d.router_port}",
        "replica_ports": list(d.router_replica_ports) or "ephemeral",
        "retry_budget": d.router_retry_budget,
        "probe_interval_s": d.router_probe_interval_s,
        "probe_backoff_max_s": d.router_probe_backoff_max_s,
        "swap_policy": d.router_swap_policy,
    }
    info["artifact_registry"] = _registry_summary(d.serve_registry_dir)
    info["stream"] = {
        "stride_time": d.stream_stride_time or "window",
        "stride_channels": d.stream_stride_channels or "window",
        "ring_samples": d.stream_ring_samples,
        "chunk_samples": d.stream_chunk_samples or "stride",
        "cycle_budget": d.stream_cycle_budget,
        "max_wait_ms": d.stream_max_wait_ms,
        "poll_ms": d.stream_poll_ms,
        "resident": d.stream_resident,
        "open_windows": d.stream_open_windows,
        "close_windows": d.stream_close_windows,
        "min_event_prob": d.stream_min_event_prob,
        "events_ring": d.stream_events_ring,
        "events_path": d.stream_events_path or "none",
    }
    info["stream_fleet"] = {
        "workers": d.stream_fleet_workers,
        "probe_interval_s": d.stream_fleet_probe_interval_s,
        "stats_interval_s": d.stream_fleet_stats_interval_s,
        "replay_margin": d.stream_fleet_replay_margin,
        "rebalance_shed_rate": d.stream_fleet_rebalance_shed_rate or "off",
        "rebalance_cooldown_s": d.stream_fleet_rebalance_cooldown_s,
        "release_timeout_s": d.stream_fleet_release_timeout_s,
    }
    info["obs"] = {
        "heartbeat_s": d.obs_heartbeat_s,
        "latency_buckets_ms": list(d.obs_latency_buckets_ms),
        "trace_ring": d.obs_trace_ring,
        "slo_p99_ms": d.obs_slo_p99_ms,
        "profile_dir": d.obs_profile_dir,
        "profile_cooldown_s": d.obs_profile_cooldown_s,
        "profile_duration_s": d.obs_profile_duration_s,
    }
    info["analysis"] = {
        "guard_defaults": {
            "tracing_guards": d.tracing_guards,
            "guard_warmup_steps": d.guard_warmup_steps,
            "guard_transfer": d.guard_transfer,
            "guard_nan_check": d.guard_nan_check,
        },
        "sanitize_defaults": {
            "sanitize": d.sanitize,
            "sanitize_every": d.sanitize_every,
        },
        "baselines": {"sanitize": _determinism_baseline(info["backend"])},
    }
    return info


def _nvidia_smi_power() -> Optional[str]:
    """``name, power.limit`` as ``nvidia-smi`` prints them, or None."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _kernel_library() -> dict:
    """The CUDA kernel library's path, whether it is on disk, its nvcc
    flags and where nvcc is — nothing is built here."""
    from dasmtl_torch.ops import _build

    path = _build.library_path()
    try:
        nvcc = _build._nvcc()
    except _build.BuildError:
        nvcc = None
    flags = " ".join(_build.NVCC_FLAGS)
    return {"path": str(path), "built": path.exists(),
            "arch": "sm_90a" if "sm_90a" in flags else flags,
            "nvcc_flags": list(_build.NVCC_FLAGS),
            "sources": [p.name for p in _build._sources()],
            "nvcc": nvcc, "compiles": _build.compiles()}


def _registry_summary(root: Optional[str]) -> dict:
    """A serving-artifact registry's versions (headers only)."""
    if not root:
        return {"status": "not-configured",
                "hint": "set --serve_registry_dir / publish with "
                        "python -m dasmtl_torch.export --registry DIR"}
    from dasmtl_torch.export import ArtifactRegistry

    entries = ArtifactRegistry(root).versions()
    if not entries:
        return {"path": root, "status": "empty"}
    return {"path": root, "status": "ok",
            "versions": [
                {k: e.get(k) for k in ("version", "file", "model",
                                       "precision", "input_hw", "corrupt")
                 if e.get(k) is not None}
                for e in entries]}


def _determinism_baseline(backend: Optional[str]) -> dict:
    """ok / stale / missing / unreadable for the committed SAN203
    baseline: ``stale`` when its stamp (card, torch, CUDA) is not this
    host's, where only its float metrics gate."""
    from dasmtl_torch.analysis.sanitize import determinism as det

    path = det.DEFAULT_BASELINE_PATH
    out = {"path": path, "size": 0, "unit": "cell(s)",
           "cli": "python -m dasmtl_torch.sanitize", "detail": "",
           "generated_with": {}}
    try:
        doc = det.load_baseline(path)
    except (OSError, ValueError) as exc:
        return {**out, "status": "unreadable", "detail": str(exc)}
    if doc is None:
        return {**out, "status": "missing"}
    stamp = det.generated_with("cuda" if backend == "cuda" else "cpu")
    out.update(size=len(doc.get("targets", {})),
               generated_with=doc.get("generated_with", {}))
    if det.versions_match(doc, stamp):
        return {**out, "status": "ok"}
    return {**out, "status": "stale",
            "detail": f"stamped {out['generated_with']}, this host is "
                      f"{stamp}: only the float metrics gate"}


def check_exported_artifact(path: str, window=None,
                            precision: Optional[str] = None) -> dict:
    """Serve precheck: does this port artifact's header match the window
    (and, given ``precision``, the preset) a server would be configured
    with?  Reads the header only.  A JAX StableHLO artifact is
    ``unreadable`` with the port's refusal."""
    from dasmtl_torch.config import INPUT_HEIGHT, INPUT_WIDTH
    from dasmtl_torch.export import artifact_header, require_port_payload

    want = tuple(window or (INPUT_HEIGHT, INPUT_WIDTH))
    try:
        header = artifact_header(path)
        require_port_payload(header, path)
        got = tuple(header["input_hw"])
    except (OSError, ValueError, KeyError, TypeError) as exc:
        return {"path": path, "status": f"unreadable ({exc})"}
    out = {"path": path,
           "status": "compatible" if got == want else "MISMATCH",
           "artifact_hw": list(got), "configured_hw": list(want),
           "artifact_version": header.get("artifact_version", 0),
           "precision": header.get("precision", "f32")}
    if precision is not None and precision != out["precision"]:
        out["status"] = "PRECISION-MISMATCH"
        out["configured_precision"] = precision
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dasmtl_torch doctor",
        description="dasmtl_torch environment doctor")
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable JSON line")
    ap.add_argument("--exported", type=str, default=None, metavar="PATH",
                    help="also validate a port serving artifact's window "
                         "against the configured one (what python -m "
                         "dasmtl_torch.serve checks before accepting "
                         "traffic); prints its precision/version header")
    ap.add_argument("--precision", type=str, default=None,
                    choices=["f32", "bf16", "int8"],
                    help="with --exported: also require the artifact's "
                         "recorded precision preset to match")
    ap.add_argument("--registry", type=str, default=None, metavar="DIR",
                    help="list a serving-artifact registry's versions")
    args = ap.parse_args(argv)
    info = collect()
    if args.registry:
        info["artifact_registry"] = _registry_summary(args.registry)
    rc = 0
    if args.exported:
        info["exported_artifact"] = check_exported_artifact(
            args.exported, precision=args.precision)
        rc = 0 if info["exported_artifact"]["status"] == "compatible" else 1
    if args.json:
        print(json.dumps(info))
        return rc
    _print_report(info)
    return rc


def _print_report(info: dict) -> None:
    print("dasmtl_torch doctor")
    print(f"  python {info['python']}")
    for mod, ver in info["versions"].items():
        print(f"  {mod:<18} {ver or 'MISSING'}")
    if info.get("backend"):
        print(f"  backend: {info['backend']} ({info['device_count']} "
              f"device(s), kind={info['device_kind']}, capability="
              f"{tuple(info['capability'])}, power: "
              f"{info.get('power_limit') or 'nvidia-smi not found'})")
        for d in info["devices"]:
            print(f"    {d}")
    else:
        print(f"  backend: UNAVAILABLE — {info.get('backend_error')}")
    for k, v in info["env"].items():
        print(f"  env {k}={v}")
    kl = info["kernel_library"]
    print(f"  kernel library: {kl['path']} "
          f"({'built' if kl['built'] else 'not built'}; {kl['arch']}; "
          f"{len(kl['sources'])} sources; nvcc "
          f"{kl['nvcc'] or 'not found'}; builds + captures in this "
          f"process {kl['compiles']})")
    nl = info["native_loader"]
    print(f"  native MAT loader: "
          f"{'available' if nl['available'] else 'scipy fallback'} "
          f"({nl['library']}; {nl['path']})")
    print("  perf defaults: " + ", ".join(
        f"{k}={v}" for k, v in info["perf_defaults"].items()))
    ld = info["loader"]
    print(f"  loader: workers={ld['workers']} "
          f"queue_depth={ld['queue_depth']} native={ld['native_mode']} "
          f"-> {ld['native_resolved']} (dasmtl_torch/data/pipeline.py)")
    for key, title, where in (
            ("serve_defaults", "serve defaults", "python -m "
                                                 "dasmtl_torch.serve"),
            ("router_defaults", "router defaults",
             "python -m dasmtl_torch.serve.router"),
            ("stream", "stream", "python -m dasmtl_torch.stream serve"),
            ("stream_fleet", "stream fleet",
             "python -m dasmtl_torch.stream fleet")):
        print(f"  {title}: " + ", ".join(
            f"{k}={v}" for k, v in info[key].items()) + f" ({where})")
    reg = info.get("artifact_registry", {})
    if reg.get("status") == "ok":
        vs = ", ".join(
            f"v{e['version']} {e.get('model')}/{e.get('precision')}"
            + (" CORRUPT" if e.get("corrupt") else "")
            for e in reg["versions"])
        print(f"  artifact registry: {reg['path']} — {vs} "
              f"(blue/green rollouts resolve here)")
    else:
        print(f"  artifact registry: {reg.get('status')}"
              + (f" at {reg['path']}" if reg.get("path") else "")
              + (f" — {reg['hint']}" if reg.get("hint") else ""))
    ob = info["obs"]
    print(f"  obs: heartbeat_s={ob['heartbeat_s']} "
          f"trace_ring={ob['trace_ring']} "
          f"slo_p99_ms={ob['slo_p99_ms']} "
          f"profile_dir={ob['profile_dir']} "
          f"(cooldown {ob['profile_cooldown_s']}s, "
          f"duration {ob['profile_duration_s']}s; "
          f"latency buckets {len(ob['latency_buckets_ms'])} x ms) "
          "(python -m dasmtl_torch obs)")
    ea = info.get("exported_artifact")
    if ea:
        _print_artifact(ea)
    ana = info["analysis"]
    print("  guard defaults: " + ", ".join(
        f"{k}={v}" for k, v in ana["guard_defaults"].items()))
    print("  sanitize defaults: " + ", ".join(
        f"{k}={v}" for k, v in ana["sanitize_defaults"].items()))
    for family, b in ana["baselines"].items():
        row = (f"  {family} baseline: {b['status']} — {b['size']} "
               f"{b['unit']} in {b['path']}")
        if b["detail"]:
            row += f" — {b['detail']}"
        if b["status"] == "ok":
            row += f"; verify with {b['cli']} --check-baseline"
        else:
            row += (f"; refresh on the card with {b['cli']} "
                    f"--update-baseline")
        print(row)


def _print_artifact(ea: dict) -> None:
    head = (f"precision {ea['precision']}, artifact "
            f"v{ea['artifact_version']}" if "precision" in ea
            else "no header")
    if ea["status"] == "compatible":
        print(f"  exported artifact: {ea['path']} compatible — "
              f"{ea['artifact_hw'][0]}x{ea['artifact_hw'][1]} windows "
              f"({head})")
    elif ea["status"] == "MISMATCH":
        print(f"  exported artifact: {ea['path']} MISMATCH — artifact "
              f"takes {ea['artifact_hw'][0]}x{ea['artifact_hw'][1]}, "
              f"config expects {ea['configured_hw'][0]}x"
              f"{ea['configured_hw'][1]} ({head}); python -m "
              f"dasmtl_torch.serve would refuse to start")
    elif ea["status"] == "PRECISION-MISMATCH":
        print(f"  exported artifact: {ea['path']} PRECISION-MISMATCH "
              f"— artifact recorded '{ea['precision']}' "
              f"(v{ea['artifact_version']}), config asks "
              f"'{ea['configured_precision']}'; re-export with python -m "
              f"dasmtl_torch.export --precision "
              f"{ea['configured_precision']} or serve with "
              f"--precision {ea['precision']}")
    else:
        print(f"  exported artifact: {ea['path']} {ea['status']}")


if __name__ == "__main__":
    sys.exit(main())
