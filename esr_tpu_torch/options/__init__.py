from esr_tpu_torch.options.options import NoneDict, check_resume, dict_to_nonedict, parse, save
