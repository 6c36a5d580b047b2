from .cameras import CAM_PARAM_DIM, pack_camera, pack_rig, project_points, project_points_np
from .example_rigs import dome_camera, dome_rig
from .grids import (
    compute_center_grids_np,
    compute_grid_np,
    norm_to_pixel,
    project_to_norm_coords,
)
from .transforms import affine_transform_points, get_resize_transform, rotate_points
