"""The port's public surface against the JAX package's: every public name
of ``normflows_tpu`` and of each subpackage and submodule the port mirrors
must exist on the port's matching module, so that code written against the
JAX package finds every name.  Names a JAX module merely imports (``jax``,
``jnp``, ``np``: anything whose module is not under ``normflows_tpu``; in a
plain module, also what it imports from another of the package's modules)
are not its surface.  The written allow-list holds what the port does not
mirror, each for its reason."""

import importlib
import types

import pytest

MODULES = ["", ".core", ".core.flow", ".flows", ".flows.neural_spline", ".flows.affine",
           ".nets", ".distributions", ".utils", ".sampling", ".sampling.adaptation",
           ".sampling.smc", ".sampling.neutra", ".sampling.nuts", ".transforms", ".data",
           ".data.native_loader", ".parallel", ".parallel.mesh", ".parallel.distributed",
           ".parallel.data_parallel", ".parallel.chains", ".parallel.tensor_parallel",
           ".parallel.pipeline"]

# the JAX package's pytree module system: the port's modules are nn.Modules
MODULE_SYSTEM = {"Module", "static_field", "buffer_field", "partition", "combine",
                 "trainable_filter", "module"}
# private names a JAX package's __init__ exports
PRIVATE = {"_LULinear", "_Permutation", "_RandomPermutation"}
# later slices of the port: none left
LATER = {}
ALLOWED = MODULE_SYSTEM | PRIVATE | set(LATER)


def public_names(module):
    """A package's public names are all it exports from the JAX package; a
    plain module's, those it defines (not what it imports for its own use)."""
    package = hasattr(module, "__path__")
    out = set()
    for name in dir(module):
        if name.startswith("__") or (name.startswith("_") and name not in PRIVATE):
            continue
        value = getattr(module, name)
        owner = value.__name__ if isinstance(value, types.ModuleType) \
            else getattr(value, "__module__", None)
        if not isinstance(owner, str) or owner.split(".")[0] != "normflows_tpu":
            continue
        if package or owner == module.__name__ or isinstance(value, types.ModuleType):
            out.add(name)
    return out


@pytest.mark.parametrize("suffix", MODULES, ids=lambda s: s.lstrip(".") or "root")
def test_every_public_name_exists(suffix):
    jmod = importlib.import_module("normflows_tpu" + suffix)
    tmod = importlib.import_module("normflows_tpu_torch" + suffix)
    missing = sorted(n for n in public_names(jmod) - ALLOWED if not hasattr(tmod, n))
    assert not missing, f"normflows_tpu_torch{suffix} lacks {missing}"


def test_allow_list_is_needed():
    """Every allowed name is one some JAX module exports and the port
    lacks, so that the list shrinks as the port grows."""
    lacking = set()
    for suffix in MODULES:
        jmod = importlib.import_module("normflows_tpu" + suffix)
        tmod = importlib.import_module("normflows_tpu_torch" + suffix)
        lacking |= {n for n in public_names(jmod) & ALLOWED if not hasattr(tmod, n)}
    assert lacking == ALLOWED
