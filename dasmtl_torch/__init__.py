"""dasmtl_torch — the PyTorch/CUDA port of :mod:`dasmtl` for one NVIDIA H100.

The JAX package ``dasmtl`` stays the reference; this package is held to it
by the ``tests/test_torch_port_*.py`` parity tests.  It imports ``torch``
and numpy only — never ``jax`` and no module of ``dasmtl``.

Slice 1 ports the serving path of model A: the eval forward
(:mod:`dasmtl_torch.models`), the on-device decode tail
(:mod:`dasmtl_torch.export`), the bucketed executor and the micro-batching
HTTP server (:mod:`dasmtl_torch.serve`).  Slice 2 ports training
(:mod:`dasmtl_torch.train`, :mod:`dasmtl_torch.data`), slice 3 the stream
tier (:mod:`dasmtl_torch.stream`: the offline record sweep and the live
multi-fiber tier, on the host or the resident data plane), slice 4 model C
(:mod:`dasmtl_torch.models.inception`) and the bf16 / int8 serving presets
(:mod:`dasmtl_torch.models.precision`, :mod:`dasmtl_torch.serve.parity`).
A later slice serves what the port trains: the versioned artifact
container and registry (``python -m dasmtl_torch.export``), the
``--model_path`` / ``--exported`` / ``--registry`` model sources, and the
server's blue/green ``POST /swap``.  The next trains model C and every
cross-validation fold at once (:mod:`dasmtl_torch.train.cv`,
``--cv_parallel``).  The hand-written Hopper kernels live in ``csrc/``
and are built on their first
CUDA call (:mod:`dasmtl_torch.ops._build`), never at import.
"""

__version__ = "0.1.0"
