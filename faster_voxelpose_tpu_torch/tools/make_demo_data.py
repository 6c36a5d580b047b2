"""Write the self-contained training fixtures that `SyntheticDataset`
reads from its DATADIR (the port's counterpart of
`scripts/make_demo_data.py`, the same arguments and the same two files):
`calibration_demo.json`, a synthetic camera rig in the flat calibration
format, and `demo_pose_bank.pkl`, a procedural pose bank, both from
`datasets/demo_data.py`'s generators.  The Panoptic profile's data:

    python -m faster_voxelpose_tpu_torch.tools.make_demo_data \\
        --out data/DemoPanoptic --views 5 --poses 2000 --skeleton panoptic15 \\
        --center 0 -500 --radius 2800 --image-size 1920 1080
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import Optional, Sequence

from ..datasets.demo_data import SKELETONS, make_pose_bank, make_rig, write_calibration


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="data/Demo")
    p.add_argument("--views", type=int, default=5)
    p.add_argument("--poses", type=int, default=500)
    p.add_argument("--radius", type=float, default=4500.0)
    p.add_argument("--image-size", type=int, nargs=2, default=[1032, 776])
    p.add_argument("--skeleton", default="panoptic15", choices=sorted(SKELETONS),
                   help="joint set of the pose bank (coco17 = the Shelf/Campus set)")
    p.add_argument("--center", type=float, nargs=2, default=[0.0, 0.0],
                   help="capture space center xy (mm); match CAPTURE_SPEC.SPACE_CENTER")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rig = make_rig(args.views, args.radius, 2200.0, tuple(args.center), args.image_size)
    write_calibration(os.path.join(args.out, "calibration_demo.json"), rig)
    bank = make_pose_bank(args.poses, skeleton=args.skeleton)
    with open(os.path.join(args.out, "demo_pose_bank.pkl"), "wb") as f:
        pickle.dump(bank, f)
    print(f"wrote {args.views}-view rig + {args.poses}-pose bank to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
