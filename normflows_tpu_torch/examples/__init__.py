"""Scripts of the port, run as modules: ``python -m normflows_tpu_torch.examples.<name>``."""
