"""Parameter networks."""

from .cnn import Conv2d, ConvNet2d, NetActNorm
from .lipschitz import (InducedNormConv2d, InducedNormLinear, LipschitzCNN, LipschitzMLP,
                        Swish)
from .mlp import MLP, Linear
from .made import MADE, MaskedFeedforwardBlock, MaskedLinear, MaskedResidualBlock
from .resnet import ConvResidualBlock, ConvResidualNet, ResidualBlock, ResidualNet
