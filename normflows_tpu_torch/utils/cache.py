"""Where the CUDA kernels are built (port of ``normflows_tpu/utils/cache.py``).

The kernels build with ``nvcc`` at first use into ``ops.cuda_build.BUILD_DIR``
(``normflows_tpu_torch/_build/`` in the package, listed in ``.gitignore``).
Opt-in, a directory that outlives the checkout, so that every later process
finds the libraries built::

    from normflows_tpu_torch.utils import enable_compilation_cache
    enable_compilation_cache()            # ~/.cache/normflows_tpu_torch
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from ..ops import cuda_build


def enable_compilation_cache(directory: Optional[str] = None) -> str:
    """Point the kernel build at ``directory`` (created if need be) and
    return it.  It acts on the builds that follow: once a kernel library is
    loaded from another directory it raises, rather than switch silently."""
    if directory is None:
        directory = os.path.join(os.path.expanduser("~"), ".cache", "normflows_tpu_torch")
    target = Path(directory).resolve()
    loaded = sorted({Path(lib._name).resolve().parent for lib in cuda_build._LIBS.values()}
                    - {target})
    if loaded:
        raise RuntimeError(f"enable_compilation_cache({directory!r}): a kernel library is "
                           f"already loaded from {loaded[0]}; call it before the first "
                           f"kernel launch")
    target.mkdir(parents=True, exist_ok=True)
    cuda_build.BUILD_DIR = target
    return str(target)
