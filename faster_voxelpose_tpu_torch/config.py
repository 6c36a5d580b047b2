"""Typed configuration system of the PyTorch port.

The same nested dataclasses and YAML schema as the JAX package's
`faster_voxelpose_tpu/config.py`, so that the repo's experiment files
load unchanged.  The port keeps its own copy (it imports nothing of the
JAX package).  `yaml` is imported only inside `load_config` and
`save_config`: the port's runtime never needs it, and `profile(name)`
builds the profile of each committed snapshot's
`configs/demo/<name>.yaml` without it.
"""

from __future__ import annotations

import dataclasses
import pathlib
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple, Union



def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (int, float)):
        return (int(v), int(v))
    return (int(v[0]), int(v[1]))


def _triple_f(v) -> Tuple[float, float, float]:
    return (float(v[0]), float(v[1]), float(v[2]))


def _triple_i(v) -> Tuple[int, int, int]:
    return (int(v[0]), int(v[1]), int(v[2]))


@dataclass
class DatasetConfig:
    DATADIR: str = ""
    COLOR_RGB: bool = False
    DATA_AUGMENTATION: bool = False
    TRAIN_DATASET: str = "panoptic"
    TRAIN_HEATMAP_SRC: str = "image"
    TEST_DATASET: str = "panoptic"
    TEST_HEATMAP_SRC: str = "image"
    CAMERA_NUM: int = 5
    ORI_IMAGE_SIZE: Tuple[int, int] = (1920, 1080)
    IMAGE_SIZE: Tuple[int, int] = (960, 512)
    HEATMAP_SIZE: Tuple[int, int] = (240, 128)
    NUM_JOINTS: int = 15
    # int (single root joint) or list of two joint ids whose mean is the root
    ROOT_JOINT_ID: Union[int, List[int]] = 2
    # 'gt' heatmap sources: rasterize the Gaussians on the device
    # (ops/heatmap_render.py) from (V, MAX_PEOPLE, J, 12) parameters
    DEVICE_RENDER: bool = False

    def __post_init__(self):
        self.ORI_IMAGE_SIZE = _pair(self.ORI_IMAGE_SIZE)
        self.IMAGE_SIZE = _pair(self.IMAGE_SIZE)
        self.HEATMAP_SIZE = _pair(self.HEATMAP_SIZE)


@dataclass
class SyntheticConfig:
    CAMERA_FILE: str = ""
    POSE_FILE: str = ""
    MAX_PEOPLE: int = 10
    NUM_DATA: int = 10000
    DATA_AUGMENTATION: bool = True


@dataclass
class NetworkConfig:
    PRETRAINED_BACKBONE: str = ""
    NUM_CHANNEL_JOINT_FEAT: int = 32
    NUM_CHANNEL_JOINT_HIDDEN: int = 64
    SIGMA: int = 3
    BETA: float = 100.0
    # compute dtype of the conv stacks: parameters stay f32, conv inputs
    # and kernels are cast to this type
    COMPUTE_DTYPE: str = "bfloat16"
    # channel multiplier of the HDN/JLN U-Nets and heads (1.0 = reference
    # topology), rounded to multiples of 8 (models/blocks.py:scaled)
    WIDTH_MULT: float = 1.0
    # The keys below select and tune the JAX package's sampling kernel.
    # The port reads none of them; they stay so that every YAML file of
    # the repo loads into the same schema.
    SAMPLING_BACKEND: str = "auto"
    PALLAS_TILE: Tuple[int, int, int] = (8, 8, 32)
    PALLAS_WINDOW: Tuple[int, int] = (40, 128)
    PALLAS_EXACT: bool = False
    PALLAS_FUSED_COORDS: bool = True
    PALLAS_INTERPRET: bool = False
    PALLAS_WHOLE: bool = True
    PALLAS_WHOLE_TILE: Tuple[int, int, int] = (8, 8, 20)
    PALLAS_WHOLE_WINDOW: Tuple[int, int] = (64, 1024)


@dataclass
class ResnetConfig:
    NUM_LAYERS: int = 50
    DECONV_WITH_BIAS: bool = False
    NUM_DECONV_LAYERS: int = 3
    NUM_DECONV_FILTERS: Tuple[int, ...] = (256, 256, 256)
    NUM_DECONV_KERNELS: Tuple[int, ...] = (4, 4, 4)
    FINAL_CONV_KERNEL: int = 1

    def __post_init__(self):
        self.NUM_DECONV_FILTERS = tuple(int(x) for x in self.NUM_DECONV_FILTERS)
        self.NUM_DECONV_KERNELS = tuple(int(x) for x in self.NUM_DECONV_KERNELS)


@dataclass
class TrainConfig:
    BATCH_SIZE: int = 8
    SHUFFLE: bool = True
    BEGIN_EPOCH: int = 0
    END_EPOCH: int = 10
    RESUME: bool = False
    OPTIMIZER: str = "adam"
    LR: float = 1e-4
    LAMBDA_LOSS_2D: float = 1.0
    LAMBDA_LOSS_1D: float = 1.0
    LAMBDA_LOSS_BBOX: float = 0.1
    LAMBDA_LOSS_FUSED: float = 5.0
    VISUALIZATION: bool = False
    VIS_TYPE: Tuple[str, ...] = ("2d_planes", "image_with_poses", "heatmaps")
    # HDN losses are gradient-accumulated over this many steps
    # (reference: lib/core/function.py:28).
    ACCUMULATION_STEPS: int = 4
    # The reference leaves the frozen backbone in train mode so BatchNorm
    # running stats keep drifting (run/train.py:115).  Default: frozen.
    UPDATE_BACKBONE_BN_STATS: bool = False
    SEED: int = 0


@dataclass
class TestConfig:
    BATCH_SIZE: int = 8
    MODEL_FILE: str = ""
    VISUALIZATION: bool = False
    VIS_TYPE: Tuple[str, ...] = ("2d_planes", "image_with_poses", "heatmaps")


@dataclass
class CaptureSpec:
    SPACE_SIZE: Tuple[float, float, float] = (4000.0, 5200.0, 2400.0)
    SPACE_CENTER: Tuple[float, float, float] = (300.0, 300.0, 300.0)
    VOXELS_PER_AXIS: Tuple[int, int, int] = (24, 32, 16)
    MAX_PEOPLE: int = 10
    MIN_SCORE: float = 0.1

    def __post_init__(self):
        self.SPACE_SIZE = _triple_f(self.SPACE_SIZE)
        self.SPACE_CENTER = _triple_f(self.SPACE_CENTER)
        self.VOXELS_PER_AXIS = _triple_i(self.VOXELS_PER_AXIS)


@dataclass
class IndividualSpec:
    SPACE_SIZE: Tuple[float, float, float] = (2000.0, 2000.0, 2000.0)
    VOXELS_PER_AXIS: Tuple[int, int, int] = (64, 64, 64)

    def __post_init__(self):
        self.SPACE_SIZE = _triple_f(self.SPACE_SIZE)
        self.VOXELS_PER_AXIS = _triple_i(self.VOXELS_PER_AXIS)


@dataclass
class ParallelConfig:
    """Scale-out knobs (no reference equivalent: the reference is
    single-GPU).  Batch is sharded over the `data` axis."""

    DATA_PARALLEL: int = 1
    MESH_AXIS_NAME: str = "data"


@dataclass
class Config:
    BACKBONE: str = "resnet"
    DEVICE: str = "tpu"  # the JAX package's default; the port ignores it
    WORKERS: int = 8
    PRINT_FREQ: int = 100
    OUTPUT_DIR: str = "output"
    LOG_DIR: str = "log"
    MODEL: str = "faster_voxelpose"

    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    SYNTHETIC: SyntheticConfig = field(default_factory=SyntheticConfig)
    NETWORK: NetworkConfig = field(default_factory=NetworkConfig)
    RESNET: ResnetConfig = field(default_factory=ResnetConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    CAPTURE_SPEC: CaptureSpec = field(default_factory=CaptureSpec)
    INDIVIDUAL_SPEC: IndividualSpec = field(default_factory=IndividualSpec)
    PARALLEL: ParallelConfig = field(default_factory=ParallelConfig)

    # ---- derived static geometry --------------------------------------
    @property
    def fine_voxels_per_axis(self) -> Tuple[int, int, int]:
        """Resolution of the virtual fine grid the JLN crop lives on.

        reference: lib/models/project_individual.py:26
        fine = int(whole_size / ind_size * (ind_voxels - 1)) + 1   (trunc)
        """
        whole = self.CAPTURE_SPEC.SPACE_SIZE
        ind = self.INDIVIDUAL_SPEC.SPACE_SIZE
        vox = self.INDIVIDUAL_SPEC.VOXELS_PER_AXIS
        return tuple(int(whole[a] / ind[a] * (vox[a] - 1)) + 1 for a in range(3))


# Keys present in reference YAMLs that this build deliberately has no use
# for (torch/cudnn runtime knobs, unused HRNet spec).  They are accepted and
# ignored so reference config files load unchanged.
_IGNORED_TOP_KEYS = {"CUDNN", "HIGHER_HRNET"}
_IGNORED_LEAF_KEYS = {("DATASET", "MEAN"), ("DATASET", "STD")}


def _apply_overlay(obj: Any, overlay: dict, path: str = "") -> None:
    for k, v in overlay.items():
        if path == "" and k in _IGNORED_TOP_KEYS:
            continue
        if not hasattr(obj, k):
            if (path, k) in _IGNORED_LEAF_KEYS:
                continue
            raise ValueError(f"{path + '.' if path else ''}{k} not a known config key")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply_overlay(cur, v, k)
            cur.__post_init__() if hasattr(cur, "__post_init__") else None
        else:
            setattr(obj, k, v)


def load_config(yaml_path: Optional[Union[str, pathlib.Path]] = None) -> Config:
    """Build a Config from defaults, overlaid with a YAML experiment file.

    Accepts the reference's YAML schema unchanged
    (reference: lib/core/config.py:174-188).
    """
    cfg = Config()
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            overlay = yaml.safe_load(f)
        if overlay:
            _apply_overlay(cfg, overlay)
        # re-normalize tuple-typed fields after overlay
        for section in (cfg.DATASET, cfg.CAPTURE_SPEC, cfg.INDIVIDUAL_SPEC, cfg.RESNET):
            section.__post_init__()
    return cfg


def save_config(cfg: Config, yaml_path: Union[str, pathlib.Path]) -> None:
    """Dump the full resolved config, which `load_config` reads back
    (reference gen_config, config.py:191)."""
    import numpy as np
    import yaml

    def to_plain(o):
        if dataclasses.is_dataclass(o):
            return {f.name: to_plain(getattr(o, f.name)) for f in dataclasses.fields(o)}
        if isinstance(o, (tuple, list)):
            return [to_plain(x) for x in o]
        if isinstance(o, np.generic):
            return o.item()
        return o

    with open(yaml_path, "w") as f:
        yaml.safe_dump(to_plain(cfg), f, default_flow_style=False)


def get_model_name(cfg: Config) -> Tuple[str, str]:
    """(name, full_name) experiment identifiers
    (reference get_model_name, lib/core/config.py:201-213)."""
    name = f"{cfg.MODEL}_{cfg.RESNET.NUM_LAYERS}"
    deconv_suffix = "".join(f"d{f}" for f in cfg.RESNET.NUM_DECONV_FILTERS)
    full_name = f"{cfg.DATASET.IMAGE_SIZE[1]}x{cfg.DATASET.IMAGE_SIZE[0]}_{name}_{deconv_suffix}"
    return name, full_name


def panoptic_synthetic_profile() -> Config:
    """The Panoptic profile of `configs/demo/panoptic_synthetic.yaml`,
    built without YAML: 5 views, 240x128 heatmaps of 15 joints, an
    80x80x20 grid over an 8x8x2 m space, 64^3 crops, MAX_PEOPLE 10.  A
    test holds it equal to `load_config` of that file."""
    cfg = Config(WORKERS=0, PRINT_FREQ=50)
    d = cfg.DATASET
    d.DATADIR = "data/DemoPanoptic"
    d.TRAIN_DATASET = d.TEST_DATASET = "synthetic"
    d.TRAIN_HEATMAP_SRC = d.TEST_HEATMAP_SRC = "gt"
    d.CAMERA_NUM = 5
    d.ORI_IMAGE_SIZE = (1920, 1080)
    d.IMAGE_SIZE = (960, 512)
    d.HEATMAP_SIZE = (240, 128)
    d.NUM_JOINTS = 15
    d.ROOT_JOINT_ID = 2
    d.DEVICE_RENDER = True
    s = cfg.SYNTHETIC
    s.CAMERA_FILE = "calibration_demo.json"
    s.POSE_FILE = "demo_pose_bank.pkl"
    s.MAX_PEOPLE = 10
    s.NUM_DATA = 5000
    s.DATA_AUGMENTATION = True
    n = cfg.NETWORK
    n.NUM_CHANNEL_JOINT_FEAT, n.NUM_CHANNEL_JOINT_HIDDEN = 32, 64
    n.SIGMA, n.BETA = 3, 100
    cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.END_EPOCH, cfg.TRAIN.LR = 4, 30, 0.0001
    cfg.TEST.BATCH_SIZE = 4
    c = cfg.CAPTURE_SPEC
    c.SPACE_SIZE = (8000.0, 8000.0, 2000.0)
    c.SPACE_CENTER = (0.0, -500.0, 800.0)
    c.VOXELS_PER_AXIS = (80, 80, 20)
    c.MAX_PEOPLE, c.MIN_SCORE = 10, 0.1
    cfg.INDIVIDUAL_SPEC.SPACE_SIZE = (2000.0, 2000.0, 2000.0)
    cfg.INDIVIDUAL_SPEC.VOXELS_PER_AXIS = (64, 64, 64)
    return cfg


def panoptic_synthetic_w05_profile() -> Config:
    """`configs/demo/panoptic_synthetic_w05.yaml`: the Panoptic profile
    with the fusion trunk at half width (WIDTH_MULT 0.5, WeightNet 16/32
    channels), 10 epochs."""
    cfg = panoptic_synthetic_profile()
    n = cfg.NETWORK
    n.NUM_CHANNEL_JOINT_FEAT, n.NUM_CHANNEL_JOINT_HIDDEN, n.WIDTH_MULT = 16, 32, 0.5
    cfg.TRAIN.END_EPOCH = 10
    return cfg


def _coco17(cfg: Config, datadir: str) -> None:
    """The COCO-17 joint set of the Shelf and Campus profiles."""
    d = cfg.DATASET
    d.DATADIR = datadir
    d.NUM_JOINTS = 17
    d.ROOT_JOINT_ID = [11, 12]


def shelf_synthetic_profile(num_data: int = 5000, epochs: int = 10) -> Config:
    """`configs/demo/shelf_synthetic_5k.yaml` (and, with 10000 scenes and
    50 epochs, `shelf_synthetic_ref.yaml`): 5 views of a 1032x776 sensor,
    200x152 heatmaps of 17 joints, the 8x8x2 m space centred at
    (450, -320)."""
    cfg = panoptic_synthetic_profile()
    _coco17(cfg, "data/DemoShelf")
    d = cfg.DATASET
    d.ORI_IMAGE_SIZE, d.IMAGE_SIZE, d.HEATMAP_SIZE = (1032, 776), (800, 608), (200, 152)
    cfg.SYNTHETIC.NUM_DATA, cfg.TRAIN.END_EPOCH = num_data, epochs
    cfg.CAPTURE_SPEC.SPACE_CENTER = (450.0, -320.0, 800.0)
    return cfg


def campus_synthetic_profile(num_data: int = 5000, epochs: int = 10) -> Config:
    """`configs/demo/campus_synthetic.yaml` (and, with 10000 scenes and
    50 epochs, `campus_synthetic_ref.yaml`): 3 views of a 360x288 sensor,
    200x160 heatmaps of 17 joints at sigma 4, the 12x12x2 m space centred
    at (3000, 4500), MAX_PEOPLE 5, batch 8."""
    cfg = panoptic_synthetic_profile()
    _coco17(cfg, "data/DemoCampus")
    d = cfg.DATASET
    d.CAMERA_NUM = 3
    d.ORI_IMAGE_SIZE, d.IMAGE_SIZE, d.HEATMAP_SIZE = (360, 288), (800, 640), (200, 160)
    cfg.SYNTHETIC.MAX_PEOPLE, cfg.SYNTHETIC.NUM_DATA = 5, num_data
    cfg.NETWORK.SIGMA = 4
    cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.END_EPOCH, cfg.TEST.BATCH_SIZE = 8, epochs, 8
    c = cfg.CAPTURE_SPEC
    c.SPACE_SIZE = (12000.0, 12000.0, 2000.0)
    c.SPACE_CENTER = (3000.0, 4500.0, 1000.0)
    c.MAX_PEOPLE = 5
    return cfg


# The profile of each committed snapshot's config, by the YAML's file stem
# (configs/demo/<stem>.yaml); each is held equal to `load_config` of its
# file by a test.
PROFILES = {
    "panoptic_synthetic": panoptic_synthetic_profile,
    "panoptic_synthetic_w05": panoptic_synthetic_w05_profile,
    "shelf_synthetic_5k": shelf_synthetic_profile,
    "shelf_synthetic_ref": lambda: shelf_synthetic_profile(10000, 50),
    "campus_synthetic": campus_synthetic_profile,
    "campus_synthetic_ref": lambda: campus_synthetic_profile(10000, 50),
}


def profile(name: str) -> Config:
    """The profile of `configs/demo/<name>.yaml`, built without YAML;
    `name` is the file's stem, and a path to the file names it too."""
    stem = pathlib.PurePath(name).stem
    if stem not in PROFILES:
        raise KeyError(f"no code-side profile for {name!r}; known: {sorted(PROFILES)}")
    return PROFILES[stem]()
