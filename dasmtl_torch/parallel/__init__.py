"""Parallelism of the port: data-parallel ranks, their process group and
the collectives of the dp train step (:mod:`.dist`), and the serving
pool's placement of batches and fibers over devices (:mod:`.placement`)."""
