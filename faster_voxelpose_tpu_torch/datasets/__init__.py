"""Dataset registry of the port (counterpart of
`faster_voxelpose_tpu/datasets/__init__.py`, reference
lib/dataset/__init__.py:10-13)."""

from .base import FrameRecord, PoseDatasetBase, collate, root_center
from .panoptic import PanopticDataset
from .shelf_campus import CampusDataset, ShelfDataset
from .synthetic import SyntheticDataset

DATASETS = {
    "panoptic": PanopticDataset,
    "shelf": ShelfDataset,
    "campus": CampusDataset,
    "synthetic": SyntheticDataset,
}


def get_dataset(name: str):
    if name not in DATASETS:
        raise KeyError(f"unknown dataset '{name}'; have {sorted(DATASETS)}")
    return DATASETS[name]
