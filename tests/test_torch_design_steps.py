"""The design-step variants of ``normflows_tpu_torch/examples/design_steps.py``
still apply to the shipped CUDA sources: each variant is the shipped source
with its one change made, written beside a copy of the shared header.  The
timing itself runs on the card only."""

import pytest

from normflows_tpu_torch.examples import design_steps
from normflows_tpu_torch.ops import made_fused, spline_cuda, spline_flat

VARIANTS = [("made", name) for name in ("fragment_split", "final_128x64", "bf16_promoted",
                                        "chain_rows_16", "chain_rows_32")] + \
           [("flat", name) for name in ("loops_256", "registers_256", "lane_groups",
                                        "backward_loops_256", "backward_registers_256",
                                        "backward_vjp_all")] + \
           [("planar", f"{step}_{name}") for step in ("planar", "planar_backward")
            for name in ("loops_256", "registers_256", "registers_64")]
SHIPPED = {"made": made_fused.SOURCE, "flat": spline_flat.SOURCE, "planar": spline_cuda.SOURCE}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    return design_steps.write_variants(tmp_path_factory.mktemp("design_steps"))


@pytest.mark.parametrize("kind,name", VARIANTS)
def test_variant_applies_to_the_shipped_source(written, kind, name):
    path = written[(kind, name)]
    shipped = SHIPPED[kind].read_text()
    text = path.read_text()
    assert text != shipped and len(text) > len(shipped) // 2
    assert (path.parent / "rqs_common.cuh").exists()


def test_variants_are_all_written(written):
    assert sorted(written) == sorted(VARIANTS)


@pytest.mark.parametrize("make", [design_steps.made_variants, design_steps.flat_variants,
                                  design_steps.planar_variants])
def test_a_stale_anchor_raises(make):
    with pytest.raises(ValueError, match="no longer holds"):
        make("// not a shipped source\nPlaneTile<kMaxTerms, 1> PlaneTile<1, 1>")
