from .config import FieldConfig, n_to_reso, cal_n_samples
from . import static, dynamic, mlps
from .alpha_mask import AlphaGridMask, update_alpha_mask, pack_alpha, unpack_alpha
