"""The port's configs against the reference's: every FULL and SMOKE
``ModelConfig`` field by field with its derived quantities, the shape
cells, the (arch × shape) matrix ``CELLS`` and the bingo-walk sizes."""

import dataclasses

import pytest

import repro.configs as jconfigs
from repro.configs import bingo_walk as j_bingo_walk
import repro_torch.configs as tconfigs
from repro_torch.configs import bingo_walk
from repro_torch.models.config import torch_dtype

DERIVED = ("repeats", "dh", "mamba_d_inner", "mamba_dt_rank",
           "has_attention", "recurrent_only")


def _same_config(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in DERIVED:
        assert getattr(got, name) == getattr(want, name), name
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert [got.is_moe_slot(s) for s in range(got.stage_period)] == \
        [want.is_moe_slot(s) for s in range(want.stage_period)]
    torch_dtype(got.dtype)                # every config's dtype is known


@pytest.mark.parametrize("kind", ["get_config", "smoke_config"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_equal_the_reference(arch, kind):
    _same_config(getattr(tconfigs, kind)(arch), getattr(jconfigs, kind)(arch))


def test_model_config_defaults_equal_the_reference():
    from repro.models.config import ModelConfig as J
    from repro_torch.models.config import ModelConfig as T
    assert [(f.name, f.default) for f in dataclasses.fields(T)] == \
        [(f.name, f.default) for f in dataclasses.fields(J)]


def test_shapes_and_cells_equal_the_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}

    def flat(cells):
        return {a: [(c["arch"], dataclasses.asdict(c["shape"]), c["skip"],
                     c["reason"]) for c in cs] for a, cs in cells.items()}
    assert flat(tconfigs.CELLS) == flat(jconfigs.CELLS)
    assert sum(c["skip"] for cs in tconfigs.CELLS.values() for c in cs) > 0


def test_bingo_walk_equals_the_reference():
    for name in ("FULL", "SMOKE"):
        assert dataclasses.asdict(getattr(bingo_walk, name)) == \
            dataclasses.asdict(getattr(j_bingo_walk, name))


def test_unknown_dtype_raises():
    with pytest.raises(ValueError):
        torch_dtype("float8")
