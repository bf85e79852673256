"""The plain (no-flow) VAE baseline: the port of ``examples/plain_vae.py``.

    python -m normflows_tpu_torch.examples.plain_vae [--epochs 15] [...]

The flow-VAE of ``examples.vae_flow`` with no flow layers (K = 0): the
reference's reparameterised Gaussian-posterior VAE, the baseline the
flow-VAE is compared with.  It takes ``vae_flow``'s flags; run both with the
same ``--data-npz``, ``--epochs`` and ``--seed`` to compare their held-out
-ELBO.
"""

from __future__ import annotations

from . import vae_flow


def main(argv=None):
    return vae_flow.main(argv, k=0)


if __name__ == "__main__":
    main()
