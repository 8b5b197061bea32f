from .encoding import positional_encoding
from .se3 import pose_to_mtx
from .rays import ids2pixel, get_ray_directions_lean, get_rays_lean, ndc_rays_blender
from .spaces import ndc2world, world2ndc, contract, contract2world
