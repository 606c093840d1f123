from esr_tpu_torch.options.options import NoneDict, dict_to_nonedict, parse, save
