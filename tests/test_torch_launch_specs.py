"""``repro_torch.launch.specs``' arithmetic against ``repro.launch.specs``.

``train_plan``, ``scan_flops_correction``, ``attn_flops_correction`` and
``moe_flops_scale`` equal the reference's for every arch in ``CELLS`` at
each of its shapes, on the 16 x 16 and 2 x 16 x 16 meshes (the
reference's on ``jax.sharding.AbstractMesh``, the port's on the same
mesh: it reads any mesh with ``axis_names`` and ``shape``).  The LM cells
themselves are tested in ``test_torch_launch_lm_cells.py`` and
``test_torch_launch_lm_numerics.py``.
"""

import pytest

from jax.sharding import AbstractMesh

from repro.configs import CELLS as J_CELLS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import specs as js

from repro_torch.configs import CELLS, SHAPES, get_config
from repro_torch.launch import specs as ts

MESHES = {"16x16": AbstractMesh((16, 16), ("data", "model")),
          "2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def test_cells_are_the_references():
    assert sorted(CELLS) == sorted(J_CELLS)
    for a in CELLS:
        assert [c["shape"].name for c in CELLS[a]] == \
            [c["shape"].name for c in J_CELLS[a]]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(J_CELLS))
def test_plan_and_corrections_equal_the_reference(arch, mesh):
    m = MESHES[mesh]
    chips = 512 if mesh == "2x16x16" else 256
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert ts.train_plan(cfg, m) == js.train_plan(jcfg, m)
    assert ts.moe_flops_scale(cfg) == js.moe_flops_scale(jcfg)
    for c in J_CELLS[arch]:
        name = c["shape"].name
        shape, jshape = SHAPES[name], J_SHAPES[name]
        tokens = shape.global_batch * shape.seq_len
        for train in (True, False):
            assert ts.scan_flops_correction(cfg, tokens, chips, train) == \
                js.scan_flops_correction(jcfg, tokens, chips, train)
        assert ts.attn_flops_correction(cfg, shape, chips) == \
            js.attn_flops_correction(jcfg, jshape, chips)
