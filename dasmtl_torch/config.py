"""The constants and serve defaults the port's serving slice reads.

Own copies of ``dasmtl/config.py`` values (the port imports nothing of
``dasmtl``): the input geometry and class counts (``:25-39``), the fresh-
init seed (``Config.seed``, ``:349``) and the serve block
(``Config.serve_*``, ``:161-174``) with its 90 % watermark rule
(``Config.serve_watermark_resolved``, ``:544-552``).  Only what the slice
reads is here — this is not a copy of the whole ``Config``.
"""

from __future__ import annotations

from typing import Optional, Sequence

# Input sample geometry: 100 fiber channels x 250 time samples.
INPUT_HEIGHT = 100
INPUT_WIDTH = 250

NUM_DISTANCE_CLASSES = 16
NUM_EVENT_CLASSES = 2

#: Seed of ``--fresh_init`` weights (the JAX ``Config.seed`` default).
SEED = 1

SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_MAX_WAIT_MS = 5.0
SERVE_QUEUE_DEPTH = 256
SERVE_INFLIGHT = 2
SERVE_HOST = "127.0.0.1"
SERVE_PORT = 8321


def serve_watermark(buckets: Sequence[int], queue_depth: int,
                    watermark: Optional[int] = None) -> int:
    """Load-shedding threshold in queued requests: ``watermark`` when set,
    else 90 % of the queue depth, but never below one full largest-bucket
    batch (so shedding cannot starve the batcher of a complete batch)."""
    if watermark is not None:
        return int(watermark)
    return max(max(buckets), int(queue_depth * 0.9))
