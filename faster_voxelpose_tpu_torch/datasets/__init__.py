"""Dataset registry of the port (counterpart of
`faster_voxelpose_tpu/datasets/__init__.py`, reference
lib/dataset/__init__.py:10-13)."""

from .base import FrameRecord, PoseDatasetBase, collate, root_center
from .synthetic import SyntheticDataset

DATASETS = {"synthetic": SyntheticDataset}
# datasets of the JAX package's registry that the port has not yet
NOT_PORTED = ("panoptic", "shelf", "campus")


def get_dataset(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"dataset '{name}' is not ported yet (ROADMAP.md Queue 1 item 4: the Panoptic, "
            "Shelf and Campus datasets with host heatmap rendering); the port has "
            f"{sorted(DATASETS)}")
    if name not in DATASETS:
        raise KeyError(f"unknown dataset '{name}'; have {sorted(DATASETS)}")
    return DATASETS[name]
