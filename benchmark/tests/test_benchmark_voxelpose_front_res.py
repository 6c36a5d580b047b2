"""roofline.voxelpose_front_res: its work at Panoptic's published shapes
by hand (439.9 MB and 78.83 GFLOP a request, bound by the bytes at 0.1313
ms), that the VoxelPose cell alone lists it, and its reading of a
fabricated trace: two launches per traced request read a share, anything
else (a program without the kernel) reads nothing."""

import pytest

from benchmark.core.record import Run
from benchmark.core.spec import load_cell
from benchmark.counts.peaks import PEAKS

NAME = "roofline.voxelpose_front_res"
CELL = "panoptic_voxelpose.heatmaps.live"
KERNEL = ("(anonymous namespace)::front_res3d_kernel((anonymous namespace)::Problem)")
FRONT = ("void (anonymous namespace)::front3d_kernel<1>((anonymous namespace)::Problem)")


def _reader():
    c = load_cell(CELL)
    return c, next(m.reader for m in c.metrics if m.name == NAME)


def test_work_at_panoptic_by_hand():
    cell, reader = _reader()
    w = reader.work(cell.config["yaml"])
    voxels = 80 * 80 * 20 + 10 * 64 ** 3  # the CPN's space and the PRN's ten cubes
    assert voxels == 2_749_440
    assert w["bytes"] == voxels * (16 * 2 + 2 * 32 * 2)
    assert w["bytes"] / 1e6 == pytest.approx(439.9, abs=0.05)
    assert w["ops"] == voxels * 2 * 32 * 16 * (27 + 1)
    assert w["ops"] / 1e9 == pytest.approx(78.83, abs=0.005)
    least = reader.least_seconds(cell.config["yaml"], PEAKS["NVIDIA H100 80GB HBM3"])
    assert least == pytest.approx(w["bytes"] / 3.35e12)
    assert least * 1e3 == pytest.approx(0.1313, abs=5e-5)


def test_only_the_voxelpose_cell_reports_it():
    assert NAME in {m.name for m in load_cell(CELL).metrics}
    for other in ("panoptic_jln64.heatmaps.live", "shelf_jln64.heatmaps.live",
                  "panoptic_jln64.images.live", "shelf_vitpose_h.images.live",
                  "panoptic_mvp.images.live"):
        assert NAME not in {m.name for m in load_cell(other).metrics}


@pytest.mark.parametrize("launches, reads", [(8, True), (4, False), (7, False), (0, False)])
def test_reads_two_launches_per_traced_request(launches, reads):
    """Four traced requests: eight launches at a third of the least time's
    rate read 33.3%; one launch each, an odd count or none read nothing;
    front3d's launches beside them are not counted."""
    cell, reader = _reader()
    y = cell.config["yaml"]
    run = Run(cell.name, 1.0, yaml=y)
    run.peaks = PEAKS["NVIDIA H100 80GB HBM3"]
    run.traced_entries = [0, 1, 2, 3]
    least = reader.least_seconds(y, run.peaks)
    run.trace = {"total_s": {"other": 1.0, FRONT: 0.5}, "count": {"other": 1, FRONT: 8}}
    if launches:
        run.trace["total_s"][KERNEL], run.trace["count"][KERNEL] = 4 * 3 * least, launches
    got = reader.read(run)
    if not reads:
        assert got is None
        return
    assert got == pytest.approx(100.0 / 3)


def test_reads_nothing_without_a_trace():
    cell, reader = _reader()
    assert reader.read(Run(cell.name, 1.0, yaml=cell.config["yaml"])) is None
