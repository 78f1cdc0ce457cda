"""A run whose timed path is broken underneath reads ``correct`` false.

Each cell at a CPU size (``conftest.TINY``), the harness's look for a card
skipped, its own limits: a sound run is correct, and each fault the cell
can have makes it incorrect: a fit that returns its first map unchanged,
half of the frames left out of the Gram (the mean taken over the rest),
and an answer altered where it is produced (the mapped forces). A cell on
one chip has no exchange between chips to leave out.
"""

import pytest
import torch

from benchmark import harness

CELLS = ["cln025_ca.feat", "solvated_1500.feat_blocked", "cln025_ca.linear_auto", "solvated_1500.linear"]


def _run(cell):
    return harness.run_cell(cell, 2**35 + 11, 0.6, False, torch.device("cpu"), lambda m: None)


def _stale(monkeypatch, cell_name):
    """The fit function returns the first map it made, whatever the frames."""
    import aggforce_torch
    import aggforce_torch.qp as qp
    from aggforce_torch.qp import fusedfeat, qplinear

    target = {
        "cln025_ca.feat": (fusedfeat, "fused_gb_linear_map"),
        "solvated_1500.feat_blocked": (qp, "fused_gb_linear_map_blocked"),
        "cln025_ca.linear_auto": (aggforce_torch, "project_forces"),
        "solvated_1500.linear": (qplinear, "qp_linear_map"),
    }[cell_name]
    original = getattr(*target)
    first = []

    def stale(*args, **kwargs):
        if not first:
            first.append(original(*args, **kwargs))
        return first[0]

    monkeypatch.setattr(*target, stale)


def _half_frames(monkeypatch, cell_name):
    """The Gram sees every other frame, scaled by two."""
    from aggforce_torch.qp import fusedfeat, qplinear

    if "feat" in cell_name:
        original = fusedfeat._site_gram

        def half(coords, forces, mask, *rest, **kw):
            keep = mask.clone()
            keep[1::2] = 0.0
            return 2.0 * original(coords, forces, keep, *rest, **kw)

        monkeypatch.setattr(fusedfeat, "_site_gram", half)
    else:
        original = qplinear._linear_gram

        def half(forces, labels, r, dtype=None):
            return 2.0 * original(forces[::2], labels, r, dtype)

        monkeypatch.setattr(qplinear, "_linear_gram", half)


def _altered_answer(monkeypatch, cell_name):
    """The mapped forces come out 0.1% too large."""
    from aggforce_torch.map import torchlinear
    from aggforce_torch.qp import fusedfeat

    if "feat" in cell_name:
        original = fusedfeat._fused_apply
        monkeypatch.setattr(
            fusedfeat, "_fused_apply", lambda *a, **k: original(*a, **k) * 1.001
        )
    else:
        original = torchlinear.fused_separable_apply

        def altered(*args):
            mc, mf = original(*args)
            return mc, mf * 1.001

        monkeypatch.setattr(torchlinear, "fused_separable_apply", altered)


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct(tiny_cell, cell_name):
    out = _run(tiny_cell(cell_name))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_stale, _half_frames, _altered_answer])
@pytest.mark.parametrize("cell_name", CELLS)
def test_fault_makes_the_run_incorrect(tiny_cell, monkeypatch, cell_name, fault):
    fault(monkeypatch, cell_name)
    out = _run(tiny_cell(cell_name))
    assert not out["correct"], out["checks"]
