"""Utilities."""

from . import eval, masks, nn, optim, preprocessing
from .masks import (create_alternating_binary_mask, create_mid_split_binary_mask,
                    create_random_binary_mask)
from .nn import (ConstScaleLayer, PeriodicFeaturesCat, PeriodicFeaturesElementwise,
                 sum_except_batch, tile)
from .optim import clear_grad, set_requires_grad, update_lipschitz
from .precision import set_compute_dtype
