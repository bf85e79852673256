"""Utilities."""

from . import eval, masks, nn, preprocessing
from .masks import (create_alternating_binary_mask, create_mid_split_binary_mask,
                    create_random_binary_mask)
from .nn import PeriodicFeaturesElementwise, sum_except_batch
from .precision import set_compute_dtype
