"""Streaming inference of the port: offline record sweeps and live fibers.

Counterpart of ``dasmtl/stream/__init__.py``:

- **offline** (:mod:`dasmtl_torch.stream.offline`) — sweep a
  ``(channels, time)`` record and write per-window predictions to CSV;
  :mod:`dasmtl_torch.stream.merge` recombines its multi-host shards;
- **live** (:mod:`dasmtl_torch.stream.live` with ``feed``, ``windower``,
  ``tracks`` and ``resident``) — continuous inference over unbounded
  multi-fiber feeds into the serve data plane, fused into event tracks;
  :mod:`dasmtl_torch.stream.selftest` is its soak.

``python -m dasmtl_torch.stream`` is the entry point.  Importing the
package loads the offline surface and the pure-Python ingestion and track
modules; the live tier, which pulls the serve stack and torch, resolves on
attribute access.  Nothing is built at import.
"""

from __future__ import annotations

from dasmtl_torch.stream.feed import (FiberFeed, FileTailSource,
                                      PlantedEvent, SocketSource,
                                      SyntheticSource, source_from_spec)
from dasmtl_torch.stream.merge import find_shards, merge_shards
from dasmtl_torch.stream.offline import (EVENT_NAMES, main, shard_csv_path,
                                         stream_predict)
from dasmtl_torch.stream.tracks import (Track, TrackBook, TrackFuser,
                                        WindowDecode)
from dasmtl_torch.stream.windower import CutWindow, LiveWindower

#: Live-tier names resolved lazily (they import the serve stack).
_LIVE_EXPORTS = {
    "StreamLoop": "dasmtl_torch.stream.live",
    "StreamTenant": "dasmtl_torch.stream.live",
    "make_stream_http_server": "dasmtl_torch.stream.live",
    "serve_main": "dasmtl_torch.stream.live",
    "run_selftest": "dasmtl_torch.stream.selftest",
    "write_stream_job_summary": "dasmtl_torch.stream.selftest",
}

__all__ = [
    "EVENT_NAMES", "stream_predict", "shard_csv_path", "main",
    "find_shards", "merge_shards",
    "FiberFeed", "SyntheticSource", "FileTailSource", "SocketSource",
    "PlantedEvent", "source_from_spec", "LiveWindower", "CutWindow",
    "TrackFuser", "TrackBook", "Track", "WindowDecode",
    *sorted(_LIVE_EXPORTS),
]


def __getattr__(name: str):
    module = _LIVE_EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
