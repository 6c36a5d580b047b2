from .service import PoseService
