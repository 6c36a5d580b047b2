"""The benchmark's own tests, on the CPU: `python -m pytest benchmark/tests`
from the checkout's root.  Tests that need the card carry the `cuda`
marker and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

os.environ.setdefault("OMP_NUM_THREADS", "4")
