from .cameras import (
    CAM_PARAM_DIM,
    pack_camera,
    pack_rig,
    project_points,
    project_points_np,
    unpack_camera,
)
from .example_rigs import dome_camera, dome_rig, perimeter_camera, perimeter_rig, ring_rig
from .grids import (
    compute_center_grids_np,
    compute_grid_np,
    norm_to_pixel,
    project_to_norm_coords,
)
from .transforms import (
    affine_transform,
    affine_transform_points,
    get_affine_transform,
    get_resize_transform,
    get_scale,
    rotate_points,
)
