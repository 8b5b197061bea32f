from .config import config_parser, parse_cmd
from .step import StepStatics, LossWeights, make_train_step, init_opt_state, train_loss
from .schedule import LrSchedule, PermutationSampler
from .trainer import Trainer
from .convert import params_from_numpy, params_to_numpy
