"""The offline record sweep — the third CLI surface of the port.

Counterpart of ``dasmtl/stream/offline.py:31-331`` (``stream_predict``,
``_emit``, ``shard_csv_path``, ``EVENT_NAMES``, ``main``): sweep a long
``(channels, time)`` record with the window grid of
:mod:`dasmtl_torch.data.windowing`, run the model over every window and
write the JAX package's CSV rows

    window_index, channel_origin, time_origin, weight,
    pred_distance_m, pred_event   (columns present per model head)

Two data paths, one forward (model + the decode-tail kernel):

- **host**: every batch's windows are cut on the host and copied to the
  card;
- **resident**: the record goes to the card ONCE; each batch sends only its
  ``(B, 2)`` int32 origins, and the window-gather kernel
  (:func:`dasmtl_torch.export.make_resident_forward`, the factory the live
  lanes share) feeds the forward directly.

The model is a port checkpoint (``--model_path``) or a port artifact
(``--exported``, :mod:`dasmtl_torch.export`) of any preset, whose header
gives the window; as in JAX (``offline.py:116-141``), an artifact streams
on the host path only (``resident="on"`` is refused, ``auto`` takes the
host) and not under ``dp``.  Every model family sweeps: model C's rows
carry the distance and event its mixed head derives.

``--sanitize`` arms the serving path's SAN202 probe (JAX
``offline.py:92-98, 152-166, 218-232``): from a checkpoint, a non-finite
flag fused over each batch's raw outputs
(:func:`~dasmtl_torch.analysis.sanitize.fingerprint.nonfinite_flags`),
copied back with its predictions; from an artifact, its ``bad_rows``
(the decode kernel's non-finite rows).  A trip raises
:class:`~dasmtl_torch.analysis.sanitize.common.NonFiniteError` with JAX's
words, and the CLI exits as JAX's does, on the exception.

The sweep keeps two batches in flight: batch ``i + 1`` is enqueued before
batch ``i``'s predictions are read back (copied into pinned memory behind a
CUDA event), so the host cuts and writes rows while the card computes.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np

EVENT_NAMES = ("striking", "excavating")

#: Options of ``python -m dasmtl.stream`` this slice does not port yet ->
#: the ROADMAP.md item that brings each.
NOT_YET_PORTED = {
    "dp": "ROADMAP.md queue 1 item 8, 'Model C, multi-device training and "
          "CV' (multi-device)",
}

#: The key of a sanitized batch's non-finite flag among its outputs.
_NONFINITE = "nonfinite"


def _resolve_stride(stride, window):
    """Per-axis ``None``/0 stride components fall back to the window."""
    if stride is None:
        return None
    return (stride[0] or window[0], stride[1] or window[1])


def shard_csv_path(out_csv: str, process_index: int,
                   process_count: int) -> str:
    """``<base>.p<i>.csv`` for one process of a sharded sweep, the path
    itself otherwise."""
    if process_count <= 1:
        return out_csv
    base, ext = os.path.splitext(out_csv)
    return f"{base}.p{process_index}{ext or '.csv'}"


def resolve_offline_resident(mode: str, record_shape, window,
                             device) -> bool:
    """``auto`` engages on CUDA whenever the record is at least
    window-sized (``offline.py:212-215``); on the CPU ``auto`` means off.
    ``on`` still needs a window-sized record (smaller ones zero-pad on the
    host path)."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown resident mode {mode!r}")
    fits = record_shape[0] >= window[0] and record_shape[1] >= window[1]
    return fits and (mode == "on" or (mode == "auto"
                                      and device.type == "cuda"))


def stream_predict(record: np.ndarray, model_path: Optional[str],
                   model: str = "MTL", batch_size: int = 256,
                   window: Optional[Tuple[int, int]] = None,
                   stride: Optional[Tuple[int, int]] = None,
                   out_csv: Optional[str] = None,
                   process_index: int = 0, process_count: int = 1,
                   resident: str = "auto", device: str = "cuda",
                   seed: Optional[int] = None,
                   exported_path: Optional[str] = None,
                   sanitize: bool = False) -> list:
    """Run ``model`` (the port checkpoint at ``model_path``, or a fresh
    init from ``seed`` when None) over every window of ``record`` on
    ``device``; returns the prediction rows and writes ``out_csv`` when
    given.  ``resident`` ("auto" | "on" | "off") picks the data path (see
    :func:`resolve_offline_resident`).  ``exported_path`` streams a port
    artifact instead (its window, its preset), on the host path; ``model``
    still names the CSV columns, as in JAX.  ``sanitize`` raises
    ``NonFiniteError`` (SAN202) on a batch with non-finite outputs."""
    import torch

    from dasmtl_torch.config import INPUT_HEIGHT, INPUT_WIDTH, SEED, Config
    from dasmtl_torch.data.windowing import (plan_windows, window_batches,
                                             window_index_batches)
    from dasmtl_torch.device import resolve_device, set_f32_numerics
    from dasmtl_torch.export import make_resident_forward
    from dasmtl_torch.main import build_state
    from dasmtl_torch.models.registry import get_model_spec
    from dasmtl_torch.ops.decode import decode_heads
    from dasmtl_torch.train.checkpoint import restore_weights

    if resident not in ("auto", "on", "off"):
        raise ValueError(f"unknown resident mode {resident!r}")
    spec = get_model_spec(model)
    dev = resolve_device(device)
    if exported_path is not None:
        return _stream_exported(record, exported_path, spec, batch_size,
                                stride, out_csv, process_index,
                                process_count, resident, dev, model_path,
                                sanitize)
    window = tuple(window or (INPUT_HEIGHT, INPUT_WIDTH))
    cfg = Config(model=model, device=dev.type,
                 seed=SEED if seed is None else int(seed))
    state = build_state(cfg, spec, dev)
    if model_path:
        restore_weights(state, model_path)
    net = state.model.eval()
    if dev.type == "cuda":
        set_f32_numerics()
    plan = plan_windows(record.shape, window=window,
                        stride=_resolve_stride(stride, window))

    def body(xs):
        with torch.inference_mode():
            heads = net(xs)
            _, preds, _ = decode_heads(heads)
            out = spec.decode_ints(preds)
            if sanitize:
                from dasmtl_torch.analysis.sanitize.fingerprint import \
                    nonfinite_flags

                (out[_NONFINITE],) = nonfinite_flags(list(heads))
        return out

    def to_device(a: np.ndarray):
        t = torch.from_numpy(a)
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t

    if resolve_offline_resident(resident, record.shape, window, dev):
        forward = make_resident_forward(body, plan.window)
        rec = torch.from_numpy(np.ascontiguousarray(record, np.float32))
        rec = rec.to(dev)
        batches = window_index_batches(plan, batch_size,
                                       process_index=process_index,
                                       process_count=process_count)

        def run(batch):
            return forward(rec, to_device(batch["origin"]))
    else:
        batches = window_batches(record, batch_size, plan=plan,
                                 process_index=process_index,
                                 process_count=process_count)

        def run(batch):
            return body(to_device(batch["x"]))

    def start(batch):
        wait = _readback(run(batch))
        if not sanitize:
            return wait
        return lambda: _checked(wait(), batch)

    return _emit(spec, plan, batches, start, out_csv, process_index,
                 process_count)


def _checked(out: Dict[str, np.ndarray], batch) -> Dict[str, np.ndarray]:
    """A sanitized batch's predictions, once its fused non-finite flag
    reads False; JAX's SAN202 ``NonFiniteError`` otherwise
    (``dasmtl/stream/offline.py:218-232``)."""
    if bool(out.pop(_NONFINITE)):
        from dasmtl_torch.analysis.sanitize.common import NonFiniteError

        idx = [int(i) for i in batch["index"] if int(i) >= 0]
        raise NonFiniteError(
            f"SAN202: non-finite model outputs while streaming "
            f"windows {idx[:8]}{'…' if len(idx) > 8 else ''} — "
            f"poisoned weights or input record; the decoded argmax "
            f"would have been silently wrong")
    return out


def _stream_exported(record, path, spec, batch_size, stride, out_csv,
                     process_index, process_count, resident, dev,
                     model_path, sanitize=False) -> list:
    """The ``exported_path`` sweep: host windows through the artifact's
    executor, two batches in flight (batch ``i + 1`` dispatched before
    batch ``i`` is collected on the executor's stream).  ``sanitize``
    reads each batch's ``bad_rows``, as JAX reads the artifact's
    ``nonfinite_rows`` (``dasmtl/stream/offline.py:152-166``)."""
    from dasmtl_torch.data.windowing import plan_windows, window_batches
    from dasmtl_torch.serve.executor import InferExecutor

    if model_path:
        raise ValueError("pass either exported_path or model_path, not "
                         "both")
    if resident == "on":
        raise ValueError(
            "resident='on' needs the window gather in front of the "
            "model's own forward, which an exported artifact does not "
            "provide — stream from a checkpoint for the resident path")
    executor = InferExecutor.from_exported(path, (batch_size,), device=dev)
    plan = plan_windows(record.shape, window=executor.input_hw,
                        stride=_resolve_stride(stride, executor.input_hw))
    batches = window_batches(record, batch_size, plan=plan,
                             process_index=process_index,
                             process_count=process_count)

    def start(batch):
        handle = executor.dispatch(batch["x"])
        return lambda: _checked_rows(*executor.collect(handle)[:2],
                                     sanitize)

    try:
        return _emit(spec, plan, batches, start, out_csv, process_index,
                     process_count)
    finally:
        executor.close()


def _checked_rows(preds: Dict[str, np.ndarray], bad: np.ndarray,
                  sanitize: bool) -> Dict[str, np.ndarray]:
    if sanitize and bad.any():
        from dasmtl_torch.analysis.sanitize.common import NonFiniteError

        raise NonFiniteError(
            f"SAN202: non-finite artifact outputs in {int(bad.sum())} "
            f"row(s) of this batch — the exported weights or the input "
            f"record are poisoned")
    return preds


def _readback(out: Dict) -> Callable[[], Dict[str, np.ndarray]]:
    """Enqueue the copy of one batch's int predictions to the host and
    return the wait for it: pinned, non-blocking copies behind a CUDA
    event on the card; plain arrays on the CPU."""
    import torch

    host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
    done = None
    if any(v.is_cuda for v in out.values()):
        done = torch.cuda.Event()
        done.record()

    def wait() -> Dict[str, np.ndarray]:
        if done is not None:
            done.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    return wait


def _emit(spec, plan, batches, start, out_csv, process_index,
          process_count) -> list:
    """Prediction rows over ``batches`` (padding slots skipped), two
    batches in flight: ``start(batch)`` enqueues one and returns the wait
    for its int predictions.  Writes the CSV shard when asked."""
    tasks = [t for t, _ in spec.report_tasks]
    fieldnames = ["window_index", "channel_origin", "time_origin", "weight"]
    fieldnames += [f for f, t in (("pred_distance_m", "distance"),
                                  ("pred_event", "event")) if t in tasks]
    rows = []

    def add_rows(batch, preds):
        for j, idx in enumerate(batch["index"]):
            if idx < 0:  # batch padding slot
                continue
            c0, t0 = plan.origin(int(idx))
            row = {"window_index": int(idx), "channel_origin": c0,
                   "time_origin": t0, "weight": float(batch["weight"][j])}
            if "distance" in preds:
                row["pred_distance_m"] = int(preds["distance"][j])
            if "event" in preds:
                row["pred_event"] = EVENT_NAMES[int(preds["event"][j])]
            rows.append(row)

    pending = None
    for batch in batches:
        wait = start(batch)
        if pending is not None:
            add_rows(pending[0], pending[1]())
        pending = (batch, wait)
    if pending is not None:
        add_rows(pending[0], pending[1]())
    if out_csv:
        out_csv = shard_csv_path(out_csv, process_index, process_count)
        os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
        with open(out_csv, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fieldnames)
            writer.writeheader()  # header even for an empty shard
            writer.writerows(rows)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dasmtl_torch.stream",
        description="dasmtl_torch streaming inference over a long DAS "
                    "record")
    p.add_argument("--record", type=str, required=True,
                   help=".mat file holding the (channels, time) matrix")
    p.add_argument("--mat_key", type=str, default="data")
    p.add_argument("--model", type=str, default="MTL")
    p.add_argument("--model_path", type=str, default=None,
                   help="port checkpoint directory (ckpts/step_<n>) to "
                        "restore weights from")
    p.add_argument("--exported", type=str, default=None,
                   help="stream a port artifact (python -m "
                        "dasmtl_torch.export) instead of a checkpoint, on "
                        "the host path; --model still names the CSV "
                        "columns")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--stride_time", type=int, default=None,
                   help="time-axis stride in samples (default: window "
                        "width, non-overlapping)")
    p.add_argument("--stride_channels", type=int, default=None)
    p.add_argument("--out", type=str, default=None,
                   help="output CSV (default: <record>.predictions.csv)")
    p.add_argument("--resident", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="keep the record on the card and gather windows "
                        "there (auto = on CUDA)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--dp", type=int, default=1, help="not yet ported")
    p.add_argument("--sanitize", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="finite-check every batch's raw model outputs and "
                        "fail naming the affected windows (SAN202) instead "
                        "of silently emitting the argmax of NaN logits")
    args = p.parse_args(argv)
    if bool(args.model_path) == bool(args.exported):
        p.error("exactly one of --model_path / --exported is required")
    if args.dp != 1 and args.exported:
        p.error("--dp is unavailable with --exported (the artifact's "
                "computation is fixed at export time)")
    if args.dp != 1:
        print(f"dasmtl_torch.stream: --dp is not yet ported: "
              f"{NOT_YET_PORTED['dp']}", file=sys.stderr)
        return 2

    from dasmtl_torch.data import matio
    from dasmtl_torch.device import resolve_device

    resolve_device(args.device)  # raises without a card, naming --device cpu
    record = matio.load_mat(args.record, key_list=(args.mat_key,))
    stride = None
    if args.stride_channels or args.stride_time:
        stride = (args.stride_channels, args.stride_time)
    out_csv = args.out or (args.record + ".predictions.csv")
    try:
        rows = stream_predict(np.asarray(record), args.model_path,
                              model=args.model, batch_size=args.batch_size,
                              stride=stride, out_csv=out_csv,
                              resident=args.resident, device=args.device,
                              exported_path=args.exported,
                              sanitize=args.sanitize)
    except (ValueError, OSError) as exc:
        # An unreadable, foreign or mismatched artifact, or --resident on
        # with one: an operational error with a named fix.
        print(f"dasmtl_torch.stream: {exc}", file=sys.stderr)
        return 2
    print(f"streamed {len(rows)} windows from {record.shape} record "
          f"-> {out_csv}")
    return 0
