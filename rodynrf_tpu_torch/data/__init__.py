from .scene import SceneData, default_focal, default_bbox
from .synthetic import make_synthetic_scene
