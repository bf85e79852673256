"""Utilities."""

from . import cache, eval, masks, nn, optim, preprocessing, profiling, splines
from .cache import enable_compilation_cache
from .eval import bitsPerDim, bitsPerDimDataset, bits_per_dim, bits_per_dim_dataset
from .masks import (create_alternating_binary_mask, create_mid_split_binary_mask,
                    create_random_binary_mask)
from .nn import (ActNorm, ClampExp, ConstScaleLayer, PeriodicFeaturesCat,
                 PeriodicFeaturesElementwise, sum_except_batch, tile)
from .optim import clear_grad, set_requires_grad, update_lipschitz
from .precision import set_compute_dtype
from .preprocessing import Jitter, Logit, Scale
