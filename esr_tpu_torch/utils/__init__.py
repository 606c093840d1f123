from esr_tpu_torch.utils.util import get_timestamp, mkdirs, setup_logger
