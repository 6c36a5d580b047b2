from .nms import maxpool_nms_2d, nms2d_topk
from .sampling import bilinear_sample_pixels, sample_and_mean_views
from .soft_argmax import soft_argmax
