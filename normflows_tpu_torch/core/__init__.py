from .flow import (Flow, Reverse, Composite, Identity, ScanChain, sum_except_batch,
                   zero_log_det_like_z)
from .facades import (ClassCondFlow, ConditionalNormalizingFlow, MultiscaleFlow, NormalizingFlow,
                      NormalizingFlowVAE, load_model, load_params_like, save_model)
