"""Data: dataset discovery, splits, sources and the batch pipeline
(counterparts of ``dasmtl/data/``; numpy and scipy only)."""
