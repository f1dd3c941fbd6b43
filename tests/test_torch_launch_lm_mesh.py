"""``chip_smoke.py``'s phase 3m on the CPU: LM cells on a real 2 × 2 mesh.

Four ranks (``spawn``) build ``init_device_mesh("cpu", (2, 2), ("data",
"model"))`` over the smoke's host-staged process group
(``register_host_staging``: gloo under a Python ``ProcessGroup`` that
tallies each collective) and run mixtral-8x7b SMOKE's train, prefill and
decode cells (dense experts, every collective kind DTensor issues) through
``lm_mesh_phase``, the phase the card runs at qwen2-0.5b's full width too.
Rank 0 holds each cell against the same function on whole tensors at
the limits of ``test_torch_launch_lm_numerics.py`` (``LM_MESH_TOL``); the
counter's prediction for each cell runs in the test process while the
ranks work.  No peak is measured on the CPU.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def test_lm_mesh_phase_on_cpu():
    report = {}
    cs.lm_mesh_phase(report, "cpu", device="cpu", archs=("mixtral-8x7b",))
    cells = report["lm_mesh"]["cells"]
    assert sorted(cells) == [f"mixtral-8x7b {n}" for n in (
        "decode_32k", "prefill_32k", "train_4k")]
    for key, row in cells.items():
        assert row["excess"] and max(row["excess"].values()) <= 1.0, key
        assert len(row["coll_bytes"]) == 4
        assert row["pred"]["flops"] > 0
    train = cells["mixtral-8x7b train_4k"]
    assert train["microbatches"] == 1
    # the step's FSDP gathers, gradient reduce-scatters and reductions
    # all crossed the staged group, the same on every rank
    calls = train["coll_calls"]
    assert all(c == calls[0] for c in calls)
    assert all(calls[0].get(k, 0) > 0 for k in (
        "all_gather", "reduce_scatter", "all_reduce"))
