"""``python -m dasmtl_torch.stream`` — the stream tier's entry point.

``serve`` as the first argument routes to the live tier
(:func:`dasmtl_torch.stream.live.serve_main`); ``fleet`` to the fleet
controller (:func:`dasmtl_torch.stream.fleet.fleet_main`); anything else
is the offline record sweep (:func:`dasmtl_torch.stream.offline.main`).
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["serve"]:
        from dasmtl_torch.stream.live import serve_main

        return serve_main(argv[1:])
    if argv[:1] == ["fleet"]:
        from dasmtl_torch.stream.fleet import fleet_main

        return fleet_main(argv[1:])
    from dasmtl_torch.stream.offline import main as offline_main

    return offline_main(argv)


if __name__ == "__main__":
    sys.exit(main())
