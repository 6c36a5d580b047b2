"""roofline.weightnet_kernel: its work at Shelf's published shapes by
hand, and its reading of a fabricated trace: one launch per traced
request reads a share, anything else (a program without the kernel)
reads nothing."""

import pytest

from benchmark.core.record import Run
from benchmark.core.spec import load_cell
from benchmark.counts.peaks import PEAKS

NAME = "roofline.weightnet_kernel"
KERNEL = "void (anonymous namespace)::weightnet_kernel<__nv_bfloat16>(float const*, ...)"


def _reader(cell="shelf_jln64.heatmaps.live"):
    c = load_cell(cell)
    return c, next(m.reader for m in c.metrics if m.name == NAME)


def test_work_at_shelf_by_hand():
    cell, reader = _reader()
    w = reader.work(cell.config["yaml"])
    maps = 3 * 10 * 17  # the 3 planes of K = 10 slots, 17 joints
    assert w["bytes"] == maps * 64 * 64 * 4 + maps * 32 * 2
    assert w["ops"] == maps * 32 * (64 * 64 * 19 + 32 * 32 * 5 + 1)


@pytest.mark.parametrize("launches, reads", [(4, True), (3, False), (0, False)])
def test_reads_one_launch_per_traced_request(launches, reads):
    cell, reader = _reader()
    run = Run(cell.name, 1.0, yaml=cell.config["yaml"])
    run.peaks = PEAKS["NVIDIA H100 80GB HBM3"]
    run.traced_entries = [0, 1, 2, 3]
    spent = 4 * 25e-6
    run.trace = {"total_s": {"other": 1.0}, "count": {"other": 1}}
    if launches:
        run.trace["total_s"][KERNEL], run.trace["count"][KERNEL] = spent, launches
    got = reader.read(run)
    if not reads:
        assert got is None
        return
    w = reader.work(cell.config["yaml"])
    least = max(w["bytes"] / 3.35e12, w["ops"] / 989e12)
    assert got == pytest.approx(100.0 * 4 * least / spent)
    assert 5.0 < got < 15.0  # bytes bound, ~2.5 us of a ~25 us kernel
