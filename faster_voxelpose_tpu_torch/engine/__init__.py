from .service import PoseService
from .validator import make_eval_step, run_validation
