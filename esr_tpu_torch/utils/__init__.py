from esr_tpu_torch.utils.logger import Logger
from esr_tpu_torch.utils.util import get_timestamp, mkdir_and_rename, mkdirs, set_random_seed, setup_logger
