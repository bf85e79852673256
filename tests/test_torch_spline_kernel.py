"""The planar spline of the port (normflows_tpu_torch/ops/spline_cuda.py).

Its plain version ``rqs_transposed_reference`` against the JAX package's
planar kernel ``rqs_transposed_pallas`` run in interpret mode, at the JAX
package's bars (tests/test_pallas.py: atol = rtol = 2e-5 on outputs, 2e-4 on
log-dets), and the wrapper's checks and dispatch.  The CUDA kernel itself is
held against the plain version on the card, in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflows_tpu.ops import spline_pallas as jpl
from normflows_tpu_torch.ops import spline_cuda
from tests.helpers import assert_close

torch.set_num_threads(2)

Y_TOL = 2e-5
LD_TOL = 2e-4
# Raw parameters with std 0.5, near the scale of a flagship MADE's output at
# init; at std 1 float32 rounding alone passes the bars on badly conditioned
# bins (see tests/test_torch_splines.py).
PARAM_STD = 0.5
TAILS = {2: ((1, 2), (5.0, float(np.pi))), 3: ((1, 2, 1), (5.0, float(np.pi), 3.0))}


def planar_inputs(F, K, B, seed=0):
    """x_t (F, B) with ~20% outside +-bound on every dim, params_t (F(3K+1), B)."""
    rng = np.random.default_rng(seed)
    bounds = np.asarray(TAILS[F][1], np.float32)[:, None]
    x_t = (rng.uniform(-1.25, 1.25, (F, B)) * bounds).astype(np.float32)
    p_t = (PARAM_STD * rng.normal(size=(F * (3 * K + 1), B))).astype(np.float32)
    return x_t, p_t


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("B", [1024, 1024 + 37])
@pytest.mark.parametrize("K", [2, 8, 10, 16, 20])
@pytest.mark.parametrize("F", [2, 3])
def test_plain_matches_jax_planar_kernel(F, K, B, inverse):
    """The models' K = 8 and 10, and the bin counts that reach the card
    kernel's other instantiations: 2 and 16 (K <= 16, bins masked) and 20
    (the loops over a runtime K)."""
    codes, bounds = TAILS[F]
    x_t, p_t = planar_inputs(F, K, B)
    yj, ldj = jpl.rqs_transposed_pallas(jnp.asarray(x_t), jnp.asarray(p_t), codes,
                                        bounds, inverse, interpret=True)
    yt, ldt = spline_cuda.rqs_transposed_reference(
        torch.from_numpy(x_t), torch.from_numpy(p_t), codes, bounds, inverse)
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)


def test_cpu_tensor_takes_plain_version_without_launch(monkeypatch):
    monkeypatch.setattr(spline_cuda, "LAUNCHES", 0)
    codes, bounds = TAILS[2]
    x_t, p_t = planar_inputs(2, 10, 100)
    x, p = torch.from_numpy(x_t), torch.from_numpy(p_t)
    y, ld = spline_cuda.rqs_transposed(x, p, codes, bounds, False)
    yr, ldr = spline_cuda.rqs_transposed_reference(x, p, codes, bounds, False)
    assert torch.equal(y, yr) and torch.equal(ld, ldr)
    assert spline_cuda.LAUNCHES == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    codes, bounds = TAILS[2]
    x_t, p_t = planar_inputs(2, 10, 64)
    x, p = torch.from_numpy(x_t), torch.from_numpy(p_t)
    with pytest.raises(TypeError, match="float32"):
        spline_cuda.rqs_transposed(x.double(), p.double(), codes, bounds, False)
    with pytest.raises(ValueError, match="contiguous"):
        spline_cuda.rqs_transposed(x.T.contiguous().T, p, codes, bounds, False)
    with pytest.raises(ValueError, match="does not fit"):
        spline_cuda.rqs_transposed(x, p[:-1], codes, bounds, False)
    with pytest.raises(ValueError, match="one tail code"):
        spline_cuda.rqs_transposed(x, p, codes[:1], bounds, False)
