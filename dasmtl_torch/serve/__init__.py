"""Online inference serving for the port: the counterpart of
:mod:`dasmtl.serve` for one CUDA device.

``python -m dasmtl_torch.serve --fresh_init --window 100x250`` binds the
HTTP front end (:mod:`dasmtl_torch.serve.server`) over a
:class:`~dasmtl_torch.serve.server.ServeLoop` and an
:class:`~dasmtl_torch.serve.executor.InferExecutor`.  Modules are imported
where they are used; importing this package builds nothing.
"""
