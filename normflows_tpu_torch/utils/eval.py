"""Evaluation helpers (port of ``normflows_tpu/utils/eval.py``): bits per
dimension of a model trained in logit space (``transforms.Logit``'s
``alpha``), +8 for 256 levels."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F


def bits_per_dim(model, x, y=None, trans: str = "logit", trans_param=(0.05,)):
    """Bits/dim of each row of ``x`` with the logit transform's correction;
    ``y`` (labels) is passed to ``model.log_prob`` when given."""
    if trans != "logit":
        raise NotImplementedError(f"The transformation {trans} is not implemented.")
    dims = float(math.prod(x.shape[1:]))
    log_q = model.log_prob(x) if y is None else model.log_prob(x, y)
    axes = tuple(range(1, x.dim()))
    sig_ = torch.sum(F.logsigmoid(x) / math.log(2), dim=axes)
    sig_ = sig_ + torch.sum(F.logsigmoid(-x) / math.log(2), dim=axes)
    b = -log_q / dims / math.log(2) - math.log2(1 - trans_param[0]) + 8
    return b + sig_ / dims


def bits_per_dim_dataset(model, data_iter, class_cond: bool = True, trans: str = "logit",
                         trans_param=(0.05,)) -> float:
    """The mean bits/dim over the ``(x, y)`` batches of ``data_iter``, rows
    whose value is NaN left out."""
    n, b_cum = 0, 0.0
    for x, y in data_iter:
        b = bits_per_dim(model, x, y if class_cond else None, trans, trans_param)
        b_np = b.detach().cpu().numpy()
        b_cum += float(np.nansum(b_np))
        n += len(x) - int(np.sum(np.isnan(b_np)))
    return b_cum / n


# the reference's names
bitsPerDim = bits_per_dim
bitsPerDimDataset = bits_per_dim_dataset
