"""The dry run's LM cells of the MoE and recurrent archs (xlstm-350m,
mixtral-8x7b, llama4-scout, jamba) on a fake world of 256 ranks: the
checks of ``test_torch_launch_lm_cells.py`` (each rank's argument bytes
against the reference's shard arithmetic, the aliased bytes, the useful
ratio, ``flops_scale``, the recurrences' costed steps, no launch), in a
file of their own so that neither file holds a test worker long.
"""

import pytest

from repro_torch.configs import CELLS

from test_torch_launch_lm_cells import (MIXED, SMALL, check_argument_bytes,
                                        check_useful_ratio_and_flops_scale,
                                        run_docs)

RUN = [(a, c["shape"].name) for a, cs in CELLS.items() for c in cs
       if not c["skip"] and a in MIXED]
# half the dense file's sequence: these archs' recurrences, experts and
# parallel mLSTM cost most; 8 steps still divide every chunk and window
SMALL_MIXED = {**SMALL, "train_4k": (8, 16), "prefill_32k": (8, 16),
               "decode_32k": (8, 16)}


@pytest.fixture(scope="module")
def docs():
    return run_docs(RUN, SMALL_MIXED)


@pytest.mark.parametrize("arch, name", RUN)
def test_argument_bytes_are_jax_shards(docs, arch, name):
    check_argument_bytes(docs[0][arch, name], arch, name, SMALL_MIXED)


@pytest.mark.parametrize("arch, name", RUN)
def test_useful_ratio_and_flops_scale(docs, arch, name):
    check_useful_ratio_and_flops_scale(docs, arch, name)


def test_no_kernel_launches(docs):
    before, after = docs[2]
    assert before == after
