"""The port's invariant checkers against JAX's (``tests/test_invariants.py``).

On a clean state and on each corruption of ``tests/test_invariants.py``,
``check_state_device``'s per-rule counts and ``check_state``'s
``Violation`` lists (rules, vertices, digits, details, in order) equal
JAX's on the same tables; the chunked device sweep equals the unchunked
one; ``vertices=`` restricts the host sweep the same way.
"""

import numpy as np
import pytest

import torch

from repro.core.invariants import check_state as j_check_state
from repro.core.invariants import check_state_device as j_check_device
from repro_torch.core import dyngraph as tdg
from repro_torch.core.dyngraph import DENSE, EMPTY
from repro_torch.core.invariants import (DEVICE_RULES, Violation,
                                         check_state, check_state_device)
from repro_torch.serve import DynamicWalkEngine
from tests.conftest import random_graph
from tests.test_torch_state import configs
from tests.test_torch_updates import _jax_state


def _state(V=16, C=8, seed=6, **kw):
    src, dst, w = random_graph(V, C, max_bias=31, seed=seed)
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=5, **kw)
    return tdg.from_edges(tcfg, src, dst, w, device="cpu"), jcfg, tcfg


def _set(x, idx, val):
    x = x.clone()
    x[idx] = val
    return x


def _add(x, idx, val):
    x = x.clone()
    x[idx] += val
    return x


CORRUPTIONS = {
    "deg_range": lambda st, c: st._replace(
        deg=_set(st.deg, 0, c.capacity + 5)),
    "live_nbr": lambda st, c: st._replace(nbr=_set(st.nbr, (0, 0), -1)),
    "stale_tail": lambda st, c: st._replace(
        nbr=_set(st.nbr, (1, c.capacity - 1), 3)),
    "bias_positive": lambda st, c: st._replace(
        bias=_set(st.bias, (0, 0), 0)),
    "digitsum": lambda st, c: st._replace(
        digitsum=_add(st.digitsum, (0, 0), 1)),
    "gsize": lambda st, c: st._replace(gsize=_add(st.gsize, (0, 0), 1)),
    "wdec": lambda st, c: st._replace(wdec=_set(st.wdec, 0, 1.0)),
}


def assert_checkers_match(st, jcfg, tcfg, **kw):
    """Both checkers of both packages agree on ``st``; returns the port's
    device counts (as a dict) and report."""
    js = _jax_state(st)
    pend = kw.get("pending_inserts", 0)
    want = np.asarray(j_check_device(js, jcfg, pend)).tolist()
    got = check_state_device(st, tcfg, pend)
    assert got.dtype == torch.int32 and got.tolist() == want
    assert check_state_device(st, tcfg, pend, chunk=3).tolist() == want
    report = check_state(st, tcfg, assert_ok=False, **kw)
    assert report == j_check_state(js, jcfg, assert_ok=False, **kw)
    assert all(isinstance(v, Violation) for v in report)
    return dict(zip(DEVICE_RULES, got.tolist())), report


@pytest.mark.parametrize("kw", [{}, dict(adaptive=False),
                                dict(fp_bias=True, lam=4.0)],
                         ids=["adaptive", "baseline", "fp"])
def test_clean_state_all_clear(kw):
    st, jcfg, tcfg = _state(**kw)
    counts, report = assert_checkers_match(st, jcfg, tcfg)
    assert report == [] and check_state(st, tcfg) == []
    assert all(v == 0 for v in counts.values())


def test_engine_audit_surfaces_device_counts():
    st, _, tcfg = _state()
    audit = DynamicWalkEngine(st, tcfg).audit()
    assert set(audit) == set(DEVICE_RULES)
    assert all(v == 0 for v in audit.values())


@pytest.mark.parametrize("rule", list(CORRUPTIONS))
def test_corruption_named_by_both_checkers(rule):
    st, jcfg, tcfg = _state()
    assert int(st.deg[0]) > 0 and int(st.deg[1]) < tcfg.capacity
    bad = CORRUPTIONS[rule](st, tcfg)
    counts, report = assert_checkers_match(bad, jcfg, tcfg)
    assert counts[rule] > 0
    assert any(v.rule == rule for v in report)
    with pytest.raises(AssertionError, match=rule):
        check_state(bad, tcfg)


def test_gtype_mismatch_flagged():
    st, jcfg, tcfg = _state()
    u, k = np.argwhere(st.gtype.numpy() != EMPTY)[0]
    bad = st._replace(gtype=_set(st.gtype, (int(u), int(k)), EMPTY))
    counts, report = assert_checkers_match(bad, jcfg, tcfg)
    assert counts["gtype"] > 0
    assert any(v.rule == "gtype" and v.vertex == u and v.digit == k
               for v in report)


def test_host_only_group_membership_rule():
    """gmem corruption is host-only (the device subset skips it)."""
    st, jcfg, tcfg = _state()
    gt, gs = st.gtype.numpy(), st.gsize.numpy()
    u, k = np.argwhere((gt != EMPTY) & (gt != DENSE) & (gs > 0))[0]
    bad = st._replace(gmem=_set(st.gmem, (int(u), int(k), 0),
                                int(st.deg[u])))
    counts, report = assert_checkers_match(bad, jcfg, tcfg)
    assert any(v.rule.startswith("gmem") and v.vertex == u for v in report)
    assert all(v == 0 for v in counts.values())


def test_report_is_selective_and_pressure_rule():
    """One corrupted vertex implicates no other; ``vertices=`` restricts
    the sweep (and copies only those rows); ``at_capacity`` fires only
    with pending inserts."""
    st, jcfg, tcfg = _state()
    bad = st._replace(digitsum=_add(st.digitsum, (2, 0), 3))
    _, report = assert_checkers_match(bad, jcfg, tcfg)
    assert {v.vertex for v in report} == {2}
    assert check_state(bad, tcfg, vertices=[0, 1], assert_ok=False) == []
    sub = check_state(bad, tcfg, vertices=[5, 2, 2], assert_ok=False)
    assert sub == j_check_state(_jax_state(bad), jcfg, vertices=[5, 2, 2],
                                assert_ok=False)
    assert sub == 2 * [v for v in report if v.vertex == 2]
    full = st._replace(deg=_set(st.deg, 3, tcfg.capacity),
                       nbr=_set(st.nbr, 3, 1),
                       bias=_set(st.bias, 3, 1))
    counts, report = assert_checkers_match(full, jcfg, tcfg,
                                           pending_inserts=2)
    assert counts["at_capacity"] >= 1
    assert any(v.rule == "at_capacity" and v.vertex == 3 for v in report)
