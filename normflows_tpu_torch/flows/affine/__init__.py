from .autoregressive import Autoregressive
from .coupling import (AffineConstFlow, AffineCoupling, AffineCouplingBlock, CCAffineConst,
                       MaskedAffineFlow)
