"""`knee.py`'s sweep and `readings.py`'s readings for a cell of the
`live_vitpose` entry, on the card:

    python3 -m benchmark.tools.vitpose knee <cell> <seconds> <rate> [<rate> ...]
    python3 -m benchmark.tools.vitpose readings [--dump <dir>] <cell> <seed> [<seed> ...]

Both tools name `drivers/live_service.py` and the ResNet-50's seeded
weights; this points their module globals at `drivers/live_vitpose.py`
and `core/vit_weights.py` for the call, and runs them unchanged.
"""

from __future__ import annotations

import sys

from benchmark.core.spec import load_cell
from benchmark.core.vit_weights import vitpose_weights
from benchmark.drivers import live_vitpose
from benchmark.tools import knee, readings


def point_at_vitpose(cell_name: str) -> None:
    """`knee.live`, `readings.live` and `readings.backbone_weights` set to
    the ViTPose's driver and weights of the cell's configuration."""
    yaml = load_cell(cell_name).config["yaml"]
    knee.live = readings.live = live_vitpose
    readings.backbone_weights = lambda joints, seed, device: vitpose_weights(yaml, seed, device)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    tool, args = argv[0], argv[1:]
    point_at_vitpose(args[2] if args[0] == "--dump" else args[0])
    if tool == "knee":
        knee.sweep(args[0], float(args[1]), [float(r) for r in args[2:]])
    elif tool == "readings":
        readings.main(args)
    else:
        raise SystemExit(f"unknown tool {tool!r}: knee or readings")


if __name__ == "__main__":
    main()
