from .base import FrameRecord, PoseDatasetBase, collate, root_center
from .synthetic import SyntheticDataset
