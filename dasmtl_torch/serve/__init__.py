"""Online inference serving for the port: the counterpart of
:mod:`dasmtl.serve` on CUDA devices.

``python -m dasmtl_torch.serve --fresh_init --window 100x250`` binds the
HTTP front end (:mod:`dasmtl_torch.serve.server`) over a
:class:`~dasmtl_torch.serve.server.ServeLoop` and an
:class:`~dasmtl_torch.serve.executor.ExecutorPool` (one warmed CUDA graph
per bucket and device, :mod:`dasmtl_torch.serve.graphs`);
``--selftest`` runs the serving soak (:mod:`dasmtl_torch.serve.selftest`).
``python -m dasmtl_torch.serve.router`` puts N such replica processes
behind one endpoint (:mod:`dasmtl_torch.serve.router` over
:mod:`dasmtl_torch.serve.replica`; ``--selftest`` runs
:mod:`dasmtl_torch.serve.selftest_router`).  Modules are imported where
they are used; importing this package builds nothing.
"""
