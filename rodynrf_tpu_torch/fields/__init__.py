from .config import FieldConfig, n_to_reso, cal_n_samples
from . import static, dynamic, mlps
