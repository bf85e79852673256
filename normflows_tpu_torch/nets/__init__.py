"""Parameter networks."""

from .mlp import MLP, Linear
from .made import MADE, MaskedLinear, MaskedResidualBlock
from .resnet import ResidualBlock, ResidualNet
