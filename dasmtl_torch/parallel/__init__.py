"""Data parallelism of the port: ranks, their process group and the
collectives of the dp train step (:mod:`.dist`)."""
