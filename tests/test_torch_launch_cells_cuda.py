"""Every LM cell's dry run on the card's torch against the committed records.

Each arch × shape of ``CELLS`` that is not skipped runs at SMOKE on a fake
2 × 2 world with fake ``cuda`` tensors (``dryrun.run_cell`` under the
dry run's counter) and must count what its record under
``experiments/dryrun_torch/smoke2x2/`` says, the records being written on
the CPU by ``python -m repro_torch.launch.dryrun --all --mesh 2x2 --sizing
smoke --out experiments/dryrun_torch/smoke2x2``: FLOPs, bytes and
collective bytes a rank within 1e-6, the peak within 1 %
(``chip_smoke.record_check``).  The model states its layouts (the decode
products on the weights' shards, the recurrences on local shards), so
the two torch versions must count alike; a cell whose layout is left to
DTensor's strategy, which the versions choose differently, fails here.
The 256-rank ``dryrun --all`` is too long for the smoke; this is where
every cell is checked on the card's torch, and with it the three FULL
train cells that torch 2.11 once counted apart from 2.13 (hubert-xlarge,
mixtral-8x7b, xlstm-350m ``train_4k``: a whole gradient meeting a partial
one, which the model now lays out itself, ``layers.grad_layout``) on a
fake world of 256 ranks against their records under
``experiments/dryrun_torch/`` (they run first, each in its own world,
before the 2 × 2 world of the module's fixture).  A CPU-only build of torch
cannot index fake CUDA tensors, so these tests carry the ``cuda`` marker
and skip without a card.  The file imports nothing of JAX:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_launch_cells_cuda.py``.
"""

import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import CELLS, smoke_config
from repro_torch.launch import dryrun

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import SMOKE2X2, record_check  # noqa: E402

RECORDS = Path(__file__).resolve().parents[1] / "experiments" / "dryrun_torch"

pytestmark = pytest.mark.cuda

LM_CELLS = [(a, c["shape"].name) for a, cs in CELLS.items() for c in cs
            if not c["skip"]]


@pytest.mark.parametrize("arch", ["hubert-xlarge", "mixtral-8x7b",
                                  "xlstm-350m"])
def test_full_train_cell_counts_its_record(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CPU-only build of torch cannot "
                    "index fake CUDA tensors")
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import mesh_axes
    with dryrun.fake_world(256):
        mesh = init_device_mesh("cuda", (16, 16),
                                mesh_dim_names=mesh_axes((16, 16)))
        doc = dryrun.run_cell(arch, "train_4k", mesh=mesh, out_dir=None,
                              verbose=False)
    assert doc["meta"]["fake_device"] == "cuda"
    record_check(doc, RECORDS / f"pod16x16__{arch}__train_4k.json",
                 f"{arch} train_4k at FULL on 16 x 16")


@pytest.fixture(scope="module")
def mesh2x2():
    """A 2 × 2 ``data`` × ``model`` mesh on a fake world of four ranks
    (module-scoped; it skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CPU-only build of torch cannot "
                    "index fake CUDA tensors")
    from torch.distributed.device_mesh import init_device_mesh
    with dryrun.fake_world(4):
        yield init_device_mesh("cuda", (2, 2),
                               mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("arch, shape", LM_CELLS)
def test_cell_counts_its_record(mesh2x2, arch, shape):
    doc = dryrun.run_cell(arch, shape, mesh=mesh2x2, cfg=smoke_config(arch),
                          out_dir=None, verbose=False)
    assert doc["meta"]["fake_device"] == "cuda"
    record_check(doc, SMOKE2X2 / f"mesh2x2__{arch}__{shape}.json",
                 f"{arch} {shape} at SMOKE on 2 x 2")
