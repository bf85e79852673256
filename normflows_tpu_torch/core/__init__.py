from .flow import Flow, Reverse, Composite, Identity, sum_except_batch, zero_log_det_like_z
from .facades import NormalizingFlow, load_params_like
