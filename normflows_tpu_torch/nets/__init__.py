"""Parameter networks."""

from .mlp import Linear
from .made import MADE, MaskedLinear, MaskedResidualBlock
from .resnet import ResidualBlock, ResidualNet
