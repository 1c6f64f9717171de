"""The serve forward, the decode tail, the resident forward, and the
versioned artifact container and registry.

Counterpart of ``dasmtl/export.py``: ``make_serve_infer_fn`` (eval-mode
model + on-device decode tail, ``:59-126``), the resident data plane's
factories ``make_resident_forward`` / ``make_resident_serve_fn``
(``:129-195``), :func:`make_precision_serve_fn`, the counterpart of
``dasmtl/models/precision.py:302-372``, which serves a model under a
precision preset, and the deployment artifact (``:198-558``).

An artifact is the JAX package's container, byte for byte: the magic
(:data:`ARTIFACT_MAGIC`), a u32 header length, the JSON header with sorted
keys (``artifact_version``, ``precision``, ``model``, ``input_hw``), then
the payload.  The port's header adds ``"payload": "torch"``, and its
payload is ``torch.save`` bytes of the preset's weights as the
transformed model holds them (:func:`~dasmtl_torch.models.precision.
stored_state_dict`): the f32 state dict, the bf16 leaves, or the int8
kernels with their f32 scales, so an int8 artifact is the smallest and
loading it quantizes nothing again.  An f32 artifact exported with
``--compute_dtype bfloat16`` carries ``"compute_dtype": "bfloat16"`` in
its header and payload (JAX bakes the dtype into its program; the port's
payload is weights, so the loader builds the bf16-compute model from the
header); an artifact without the key reads as float32, and a reduced
preset builds its own program whatever the flag says, as JAX's
``precision_forward`` does.  A JAX artifact (a StableHLO payload,
no ``payload`` key) or a legacy headerless blob is refused with an
operational ``ValueError`` before ``torch.load`` sees a byte of it.

:class:`ArtifactRegistry` keeps versions as ``v0007-<model>-<precision>
.torch`` files, so JAX's registry (``*.stablehlo``) never resolves one;
in a directory shared with JAX, a ``.stablehlo`` entry is listed
``corrupt`` with a reason naming it a JAX artifact, and version numbers
stay monotone across both.

CLI::

    python -m dasmtl_torch.export --model MTL --model_path <ckpt dir> \
        --out runs/mtl.torch [--registry DIR] [--precision int8] \
        [--device cpu]
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import io
import json
import os
import re
import struct
import sys
import tempfile
from typing import List, Optional

import torch
from torch import nn

from dasmtl_torch.models.layers import COMPUTE_DTYPES, compute_dtype_of
from dasmtl_torch.models.precision import (PRECISIONS, PrecisionMeta,
                                           apply_precision, check_precision,
                                           compute_dtype_for, precision_meta,
                                           rederive_buffers,
                                           stored_state_dict)
from dasmtl_torch.models.registry import ModelSpec, get_model_spec
from dasmtl_torch.ops.decode import PROB_Q_SCALE, decode_heads, event_prob_q
from dasmtl_torch.ops.window import window_gather

__all__ = ["PROB_Q_SCALE", "make_serve_infer_fn", "make_precision_serve_fn",
           "nonfinite_rows", "make_resident_forward",
           "make_resident_serve_fn", "ARTIFACT_MAGIC", "ARTIFACT_VERSION",
           "export_infer", "pack_artifact", "split_artifact",
           "read_artifact", "artifact_header", "load_artifact",
           "load_artifact_model", "ArtifactRegistry", "main"]

#: Container magic of versioned artifacts (``dasmtl/export.py:48-50``); a
#: file not starting with this is a legacy bare ``jax.export`` blob.
ARTIFACT_MAGIC = b"DASMTL\x00\x01"

#: Current container schema.  0 is reserved for legacy headerless blobs.
ARTIFACT_VERSION = 1

#: The header's ``payload`` value of the port's artifacts; a JAX artifact
#: has no ``payload`` key (its payload is StableHLO).
PAYLOAD_KIND = "torch"

#: Where a refusal of a JAX artifact points.
_CONVERTER = ("a JAX artifact holds a StableHLO program, not weights: "
              "convert the JAX run's checkpoints with python "
              "scripts/convert_jax_checkpoint.py --run <JAX run dir> --out "
              "<runs dir>, then export one with python -m "
              "dasmtl_torch.export")


def make_serve_infer_fn(spec: ModelSpec, model: nn.Module) -> Callable:
    """``serve_infer(x) -> dict`` over ``(b, h, w, 1)`` f32 windows on the
    model's device, with the JAX function's keys: per-task ``int32``
    predictions, ``log_probs_<i>`` (f32) per head and ``bad_rows`` (bool,
    True where any head of the row is non-finite).  The whole decode tail
    is ONE :func:`~dasmtl_torch.ops.decode.decode_heads` launch; nothing
    syncs with the host."""
    model.eval()

    def serve_infer(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return _decoded(spec, model(x))

    return serve_infer


def _decoded(spec: ModelSpec, heads) -> Dict[str, torch.Tensor]:
    """The decode tail's outputs: per-task ints (model C's mixed decode
    derives distance and event from its one head), ``log_probs_<i>``,
    ``bad_rows``."""
    log_probs, preds, bad = decode_heads(heads)
    out: Dict[str, torch.Tensor] = spec.decode_ints(preds)
    for i, lp in enumerate(log_probs):
        out[f"log_probs_{i}"] = lp
    out["bad_rows"] = bad
    return out


def make_precision_serve_fn(spec: ModelSpec, model: nn.Module,
                            precision: str
                            ) -> Tuple[Callable, PrecisionMeta]:
    """``(serve_infer, meta)`` for ``model`` under ``precision``.  f32
    returns :func:`make_serve_infer_fn` as it is.  A reduced preset
    transforms ``model`` in place, once (:func:`~dasmtl_torch.models.
    precision.apply_precision`), then serves it as
    :func:`transformed_serve_fn` does."""
    meta = precision_meta(model, check_precision(precision))
    apply_precision(model, precision)
    return transformed_serve_fn(spec, model, precision), meta


def transformed_serve_fn(spec: ModelSpec, model: nn.Module,
                         precision: str) -> Callable:
    """The serve forward of a model already transformed for
    ``precision``: under a reduced preset it casts the input to bf16 and
    the heads to f32, then makes the one ``decode_heads`` launch, so the
    decode tail never runs in reduced precision.  Same keys as the f32
    forward."""
    if precision == "f32":
        return make_serve_infer_fn(spec, model)
    model.eval()
    dtype = compute_dtype_for(precision)

    def serve_infer(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            heads = [h.float() for h in model(x.to(dtype))]
            return _decoded(spec, heads)

    return serve_infer


def nonfinite_rows(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``(rows,)`` bool: True where any ``log_probs_*`` head of the row
    holds NaN or Inf (``dasmtl/export.py:90-109``); all False without
    such heads."""
    heads = [v for k, v in sorted(out.items()) if k.startswith("log_probs_")]
    if not heads:
        first = next(iter(out.values()))
        return torch.zeros(first.shape[0], dtype=torch.bool,
                           device=first.device)
    bad = torch.zeros(heads[0].shape[0], dtype=torch.bool,
                      device=heads[0].device)
    for v in heads:
        bad |= ~torch.isfinite(v.reshape(v.shape[0], -1)).all(dim=1)
    return bad


def make_resident_forward(body_fn: Callable, window) -> Callable:
    """``forward(rec, origins) -> body_fn(xs)``: ``rec`` a ``(C, T)`` f32
    or bf16 record or ring already on the device, ``origins`` ``(k, 2)``
    int32 ``(channel, time)`` starts on the same device, ``xs`` the ``(k,
    h, w, 1)`` windows cut by ONE :func:`~dasmtl_torch.ops.window.
    window_gather` launch, in the record's dtype: a reduced preset's bf16
    windows reach its forward unchanged, as in JAX, and its first layer
    takes them as they are.  The shared core of the offline resident
    sweep and the live resident lanes, so the two stay int-exact twins."""
    hw = (int(window[0]), int(window[1]))

    def forward(rec: torch.Tensor, origins: torch.Tensor):
        return body_fn(window_gather(rec, origins, hw))

    return forward


def make_resident_serve_fn(infer_fn: Callable, window) -> Callable:
    """:func:`make_resident_forward` over a serve forward ``infer_fn``
    (``(k, h, w, 1) -> outputs``) with the resident decode contract: the
    outputs always carry ``bad_rows`` (:func:`nonfinite_rows` when
    ``infer_fn`` lacks it) and, when ``infer_fn`` emits
    ``log_probs_event``, the quantized confidence ``event_prob_q``
    (:func:`~dasmtl_torch.ops.decode.event_prob_q`, its own launch).
    Model A names its heads ``log_probs_0`` / ``log_probs_1``, so for it
    no ``event_prob_q`` is made — as in the JAX package, whose resident
    collector then reads a confidence of 1.0."""

    def serve_body(xs: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = dict(infer_fn(xs))
        if "bad_rows" not in out:
            out["bad_rows"] = nonfinite_rows(out)
        lp = out.get("log_probs_event")
        if lp is not None:
            out["event_prob_q"] = event_prob_q(lp)
        return out

    return make_resident_forward(serve_body, window)


# -- the exported artifact -----------------------------------------------------

def export_infer(spec: ModelSpec, model: nn.Module, *,
                 input_hw=(100, 250), precision: str = "f32",
                 compute_dtype: str = "float32") -> bytes:
    """Versioned artifact bytes of ``model`` (f32 weights of ``spec``'s
    family, on any device; left unchanged) under ``precision``
    (``dasmtl/export.py:198-248``).  The preset's transform runs here,
    once, on the CPU, as :meth:`~dasmtl_torch.serve.executor.
    InferExecutor.from_state_dict` runs it, so an executor loaded from
    the artifact gives the same bits as one built from the weights.
    ``input_hw`` is the window the artifact declares; consumers validate
    their window against it.  ``compute_dtype`` bfloat16 is recorded for
    the f32 preset only (a reduced preset computes in bf16 already)."""
    check_precision(precision)
    compute_dtype_of(compute_dtype)
    if precision != "f32":
        compute_dtype = "float32"
    net = spec.build()
    net.load_state_dict({k: v.detach().cpu()
                         for k, v in model.state_dict().items()},
                        strict=True)
    apply_precision(net, precision)
    h, w = int(input_hw[0]), int(input_hw[1])
    header = {"artifact_version": ARTIFACT_VERSION, "precision": precision,
              "model": spec.name, "input_hw": [h, w],
              "payload": PAYLOAD_KIND}
    payload = {"model": spec.name, "precision": precision,
               "input_hw": [h, w], "weights": stored_state_dict(net)}
    if compute_dtype != "float32":
        header["compute_dtype"] = payload["compute_dtype"] = compute_dtype
    buf = io.BytesIO()
    torch.save(payload, buf)
    return pack_artifact(buf.getvalue(), header)


def pack_artifact(payload: bytes, header: dict) -> bytes:
    """``magic + u32 header length + JSON header + payload``."""
    head = json.dumps(header, sort_keys=True).encode("utf-8")
    return ARTIFACT_MAGIC + struct.pack("<I", len(head)) + head + payload


def split_artifact(blob: bytes, origin: str = "<bytes>"
                   ) -> Tuple[dict, bytes]:
    """``(header, payload)`` of in-memory artifact bytes, JAX's or the
    port's.  A legacy bare blob (no container magic) returns the payload
    unchanged under a synthesized ``{"artifact_version": 0, "precision":
    "f32"}`` header, as in JAX."""
    if not blob.startswith(ARTIFACT_MAGIC):
        return {"artifact_version": 0, "precision": "f32"}, blob
    off = len(ARTIFACT_MAGIC)
    (n,) = struct.unpack_from("<I", blob, off)
    off += 4
    try:
        header = json.loads(blob[off:off + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError(f"corrupt artifact header in {origin}: {exc}") \
            from None
    _validate_header(header, origin)
    return header, blob[off + n:]


def read_artifact(path: str) -> Tuple[dict, bytes]:
    """``(header, payload)`` of an artifact file (see
    :func:`split_artifact`)."""
    with open(path, "rb") as f:
        blob = f.read()
    return split_artifact(blob, origin=path)


def _validate_header(header: dict, path: str) -> None:
    version = header.get("artifact_version")
    if not isinstance(version, int) or version < 0:
        raise ValueError(f"artifact {path} has a bad artifact_version "
                         f"{version!r}")
    if version > ARTIFACT_VERSION:
        raise ValueError(
            f"artifact {path} is version {version}, this dasmtl reads up "
            f"to {ARTIFACT_VERSION} — upgrade dasmtl or re-export")
    precision = header.get("precision", "f32")
    if precision not in PRECISIONS:
        raise ValueError(f"artifact {path} declares unknown precision "
                         f"{precision!r}; known: {PRECISIONS}")
    compute_dtype = header.get("compute_dtype", "float32")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"artifact {path} declares unknown compute_dtype "
                         f"{compute_dtype!r}; known: "
                         f"{tuple(COMPUTE_DTYPES)}")


def require_port_payload(header: dict, origin: str) -> None:
    """Raise ``ValueError`` unless ``header`` marks a port payload: a JAX
    artifact (StableHLO) or a legacy headerless blob cannot run here."""
    kind = header.get("payload")
    if kind == PAYLOAD_KIND:
        return
    if kind is None:
        what = ("a legacy headerless JAX StableHLO blob"
                if header.get("artifact_version", 0) == 0
                else "a JAX StableHLO artifact")
        raise ValueError(f"artifact {origin} is {what}, which dasmtl_torch "
                         f"cannot run; {_CONVERTER}")
    raise ValueError(f"artifact {origin} holds a {kind!r} payload; "
                     f"dasmtl_torch reads {PAYLOAD_KIND!r} payloads only")


def artifact_header(path: str) -> dict:
    """Header only, JAX's or the port's, without reading the payload."""
    return read_artifact(path)[0]


def load_artifact(path: str) -> Tuple[dict, dict]:
    """``(header, payload)``: the container parsed and validated, the
    port's payload (``model``, ``precision``, ``input_hw``, ``weights``)
    read with ``torch.load(weights_only=True)`` onto the CPU, and the
    header cross-checked against it (a mismatch means a corrupt or
    hand-edited file).  A JAX artifact is refused before the payload is
    read."""
    header, blob = read_artifact(path)
    require_port_payload(header, path)
    try:
        payload = torch.load(io.BytesIO(blob), map_location="cpu",
                             weights_only=True)
        recorded = (payload["model"], payload["precision"],
                    list(payload["input_hw"]),
                    payload.get("compute_dtype", "float32"))
    except Exception as exc:  # noqa: BLE001 — any unreadable payload
        raise ValueError(f"artifact {path} has a corrupt payload "
                         f"({type(exc).__name__}: {exc}); re-export") \
            from None
    said = (header.get("model"), header.get("precision", "f32"),
            header.get("input_hw"), header.get("compute_dtype", "float32"))
    if said != recorded:
        raise ValueError(f"artifact {path} header says {said} but its "
                         f"payload holds {tuple(recorded)} — the file is "
                         f"corrupt; re-export")
    return header, payload


def load_artifact_model(path: str
                        ) -> Tuple[dict, ModelSpec, nn.Module, PrecisionMeta]:
    """``(header, spec, model, meta)`` of the artifact at ``path``: the
    family's model on the CPU in eval mode, computing in the header's
    ``compute_dtype`` (float32 when absent), transformed for the stored
    preset, then loaded with the stored tensors and its derived buffers
    rebuilt from them (nothing quantized again), and the preset's
    :class:`PrecisionMeta`.  A payload whose keys differ from what the
    transformed model stores raises ``ValueError``."""
    header, payload = load_artifact(path)
    spec = get_model_spec(header["model"])
    precision = header.get("precision", "f32")
    net = spec.build(compute_dtype_of(header.get("compute_dtype",
                                                 "float32")))
    meta = precision_meta(net, precision)
    apply_precision(net, precision)
    weights = payload["weights"]
    want, have = set(stored_state_dict(net)), set(weights)
    if want != have:
        raise ValueError(f"artifact {path}: stored weights do not fit the "
                         f"model: missing {sorted(want - have)[:4]}, "
                         f"unexpected {sorted(have - want)[:4]}")
    try:
        net.load_state_dict(weights, strict=False)
    except RuntimeError as exc:
        raise ValueError(f"artifact {path}: {exc}") from None
    return header, spec, rederive_buffers(net).eval(), meta


# -- versioned artifact registry ----------------------------------------------

#: The port's registry entry: zero-padded monotone version, then the
#: header's model and precision for human listing.
_REGISTRY_RE = re.compile(r"^v(\d{4,})-[A-Za-z0-9_.-]+\.torch$")
#: A JAX registry entry (``dasmtl/export.py:365``) in a shared directory.
_JAX_ENTRY_RE = re.compile(r"^v(\d{4,})-[A-Za-z0-9_.-]+\.stablehlo$")


class ArtifactRegistry:
    """A directory of versioned serving artifacts
    (``dasmtl/export.py:360-489``): one ``v0007-<model>-<precision>.torch``
    file per published version and no index file, the header inside each
    artifact being the truth.  Versions are monotone ints assigned at
    ``publish`` (max existing + 1, JAX entries counted); publishing
    validates the blob, then writes a temp file and renames it, so a
    reader never sees a torn artifact.

    ``python -m dasmtl_torch.serve --registry DIR --registry_version 7``
    resolves from here, and so does each ``POST /swap {"version": ...}``.
    """

    def __init__(self, root: str):
        self.root = str(root)

    def versions(self) -> List[dict]:
        """Every entry, ascending by version: ``{"version", "path",
        "file", "model", "precision", "input_hw", "artifact_version"}``.
        Files matching neither naming convention are ignored; a matching
        file that cannot serve here (an unreadable header, a JAX
        artifact) is a ``"corrupt"`` entry naming why, never hidden."""
        try:
            names = sorted(os.listdir(self.root))
        except FileNotFoundError:
            return []
        out = []
        for name in names:
            m = _REGISTRY_RE.match(name) or _JAX_ENTRY_RE.match(name)
            if not m:
                continue
            path = os.path.join(self.root, name)
            entry = {"version": int(m.group(1)), "path": path, "file": name}
            try:
                header = artifact_header(path)
                require_port_payload(header, path)
                entry.update(
                    model=header.get("model"),
                    precision=header.get("precision", "f32"),
                    input_hw=header.get("input_hw"),
                    artifact_version=header.get("artifact_version", 0))
            except (OSError, ValueError) as exc:
                entry["corrupt"] = str(exc)
            out.append(entry)
        out.sort(key=lambda e: e["version"])
        return out

    def latest(self) -> Optional[dict]:
        good = [e for e in self.versions() if "corrupt" not in e]
        return good[-1] if good else None

    def resolve(self, version=None) -> dict:
        """The entry for ``version`` (int, numeric string, ``"latest"``
        or None = latest).  Raises ``ValueError`` with an operational
        message naming what IS available."""
        entries = [e for e in self.versions() if "corrupt" not in e]
        have = ", ".join(f"v{e['version']}" for e in entries) or "none"
        if version in (None, "latest"):
            if not entries:
                raise ValueError(
                    f"artifact registry {self.root} holds no readable "
                    f"versions — publish one with python -m "
                    f"dasmtl_torch.export --registry {self.root}")
            return entries[-1]
        try:
            want = int(version)
        except (TypeError, ValueError):
            raise ValueError(
                f"bad registry version {version!r} (an int or "
                f"'latest'); available: {have}") from None
        for e in entries:
            if e["version"] == want:
                return e
        raise ValueError(
            f"artifact registry {self.root} has no version {want}; "
            f"available: {have}")

    def publish(self, blob: bytes) -> dict:
        """Commit artifact bytes as the next version; returns its entry.
        The blob is parsed and validated FIRST (a corrupt or JAX artifact
        never occupies a version slot), then written via temp file +
        rename."""
        origin = f"publish->{self.root}"
        header, _ = split_artifact(blob, origin=origin)
        require_port_payload(header, origin)
        existing = self.versions()
        version = (existing[-1]["version"] + 1) if existing else 1
        name = (f"v{version:04d}-{header.get('model', 'model')}-"
                f"{header.get('precision', 'f32')}.torch")
        os.makedirs(self.root, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, os.path.join(self.root, name))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return {"version": version, "path": os.path.join(self.root, name),
                "file": name, "model": header.get("model"),
                "precision": header.get("precision", "f32"),
                "input_hw": header.get("input_hw"),
                "artifact_version": header.get("artifact_version", 0)}

    def publish_file(self, path: str) -> dict:
        with open(path, "rb") as f:
            return self.publish(f.read())


# -- CLI ----------------------------------------------------------------------

def main(argv=None) -> int:
    """``python -m dasmtl_torch.export`` (``dasmtl/export.py:491-558``)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m dasmtl_torch.export",
        description="Export a port checkpoint as a versioned inference "
                    "artifact")
    ap.add_argument("--model", type=str, default="MTL")
    ap.add_argument("--model_path", type=str, required=True,
                    help="port checkpoint dir (ckpts/step_<n> or best) to "
                         "read the weights from")
    ap.add_argument("--out", type=str, default=None,
                    help="output file (suggested suffix: .torch)")
    ap.add_argument("--registry", type=str, default=None, metavar="DIR",
                    help="also/instead publish into a versioned artifact "
                         "registry directory (next monotone version)")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="where the checkpoint is read (the artifact is "
                         "device-free: it loads onto either)")
    ap.add_argument("--compute_dtype", type=str, default="float32",
                    choices=list(COMPUTE_DTYPES),
                    help="the convolutions' dtype the f32 preset serves "
                         "in, recorded in the artifact header (a reduced "
                         "--precision computes in bf16 whatever this says)")
    ap.add_argument("--precision", type=str, default="f32",
                    choices=list(PRECISIONS),
                    help="serving precision preset stored in the artifact "
                         "(bf16: bf16 weights; int8: per-channel int8 "
                         "kernels + f32 scales; decode tail f32 always)")
    args = ap.parse_args(argv)
    if not args.out and not args.registry:
        ap.error("nowhere to write: give --out PATH and/or --registry DIR")
    from dasmtl_torch.device import resolve_device
    from dasmtl_torch.train.checkpoint import checkpoint_weights

    try:
        spec = get_model_spec(args.model)
    except ValueError as exc:
        print(f"dasmtl_torch.export: {exc}", file=sys.stderr)
        return 2
    weights = checkpoint_weights(args.model_path,
                                 resolve_device(args.device))
    net = spec.build()
    net.load_state_dict(weights, strict=True)
    print(f"restored weights from {args.model_path}", file=sys.stderr)

    blob = export_infer(spec, net, precision=args.precision,
                        compute_dtype=args.compute_dtype)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "wb") as f:
            f.write(blob)
        dtype = artifact_header(args.out).get("compute_dtype", "float32")
        print(f"exported {args.model} inference ({len(blob)/1e6:.2f} MB, "
              f"precision {args.precision}, compute dtype {dtype}, "
              f"artifact v{ARTIFACT_VERSION}, any batch size) -> "
              f"{args.out}")
    if args.registry:
        entry = ArtifactRegistry(args.registry).publish(blob)
        print(f"published {args.model} inference as registry "
              f"v{entry['version']} (precision {entry['precision']}) "
              f"-> {entry['path']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
