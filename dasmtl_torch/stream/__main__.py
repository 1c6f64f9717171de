"""``python -m dasmtl_torch.stream`` — the stream tier's entry point.

``serve`` as the first argument routes to the live tier
(:func:`dasmtl_torch.stream.live.serve_main`); ``fleet``, the fleet
controller, exits 2 (not yet ported); anything else is the offline record sweep
(:func:`dasmtl_torch.stream.offline.main`).
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["serve"]:
        from dasmtl_torch.stream.live import serve_main

        return serve_main(argv[1:])
    if argv[:1] == ["fleet"]:
        print("dasmtl_torch.stream: fleet is not yet ported: ROADMAP.md "
              "queue 1 item 1, 'the stream tier's remainder' (the fleet "
              "controller; its worker is python -m dasmtl_torch.stream "
              "serve --fleet_worker)", file=sys.stderr)
        return 2
    from dasmtl_torch.stream.offline import main as offline_main

    return offline_main(argv)


if __name__ == "__main__":
    sys.exit(main())
