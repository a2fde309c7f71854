from audiogpt_tpu_torch.models.face.audio2motion import (  # noqa: F401
    Audio2MotionConfig,
    Audio2MotionVAE,
    energy_articulation,
    inference_tree,
    kl_gauss,
    pseudo_motion_targets,
    resize_time,
)
from audiogpt_tpu_torch.models.face.renderer import (  # noqa: F401
    LandmarkWarper,
    default_portrait,
    template_landmarks,
)
