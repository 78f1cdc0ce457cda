"""The program's layer spans (``utils.prof.span``): where each fit enters
them under ``torch.profiler``, and that they cost no profiler call when no
profiler runs."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import aggforce_torch as pt
from aggforce_torch.qp.featlinearmap import Multifeaturize, id_feat, qp_feat_linear_map
from aggforce_torch.qp.feat import gb_feat
from aggforce_torch.qp.fusedfeat import GBFeatSpec, fused_gb_linear_map, fused_gb_linear_map_blocked
from aggforce_torch.qp.qplinear import qp_linear_map
from aggforce_torch.utils.funcs import Curry
from aggforce_torch.utils.prof import LAYER_SPANS, span
from aggforce_torch.utils.synth import synthesize_trajectory

N_ATOMS = 24
GROUPS = {frozenset((i, i + 1)) for i in range(0, 12, 2)}
SITES = [[i] for i in range(0, N_ATOMS, 5)]  # 5 sites
KBT = 0.7
SPEC = GBFeatSpec(outer=2.0, n_basis=3)


@pytest.fixture(scope="module")
def system():
    base = np.random.default_rng(11).normal(scale=0.5, size=(N_ATOMS, 3))
    coords, forces = synthesize_trajectory(base, GROUPS, 96, seed=4)
    return coords.astype(np.float32), forces.astype(np.float32)


def _cmap():
    return pt.LinearMap(SITES, n_fg_sites=N_ATOMS)


def _recorded(fn):
    """(fn's result, its aggforce.* spans as (name, start, end) in order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [
        (e.name, e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.name.startswith("aggforce.")
    ]
    return out, sorted(spans, key=lambda sp: sp[1])


def _names(spans):
    return [name for name, _, _ in spans]


def _inside(child, spans, parent_name):
    """Whether a ``parent_name`` span other than ``child`` covers ``child``."""
    _, s, e = child
    return any(
        name == parent_name and ps <= s and e <= pe and (name, ps, pe) != child
        for name, ps, pe in spans
    )


def _feat_project_forces(coords, forces):
    featurizer = Multifeaturize(
        [id_feat, Curry(gb_feat, outer=SPEC.outer, n_basis=SPEC.n_basis)]
    )
    return pt.project_forces(
        coords, forces, _cmap(), constrained_inds=GROUPS, method=qp_feat_linear_map,
        featurizer=featurizer, kbt=KBT, l2_regularization=1e3, device="cpu",
    )


def _blocked_fit(coords, forces, **kw):
    return fused_gb_linear_map_blocked(
        pt.Trajectory(coords=coords, forces=forces), _cmap(), kbt=KBT, spec=SPEC,
        constraints=GROUPS, l2_regularization=1e3, site_block=2,
        constraint_rng=np.random.default_rng(0), device="cpu", **kw,
    )


def _fused_fit(coords, forces, **kw):
    return fused_gb_linear_map(
        pt.Trajectory(coords=coords, forces=forces), _cmap(), kbt=KBT, spec=SPEC,
        constraints=GROUPS, l2_regularization=1e3,
        constraint_rng=np.random.default_rng(0), device="cpu", **kw,
    )


def _linear_fit(coords, forces, **kw):
    return qp_linear_map(
        pt.Trajectory(coords=coords, forces=forces), _cmap(), constraints=GROUPS,
        device="cpu", **kw,
    )


# (call, layers each inside an aggforce.entry span, aggforce.gram count)
FITS = {
    "project_forces_featurized": (
        _feat_project_forces,
        ("aggforce.gram", "aggforce.constraints", "aggforce.solve", "aggforce.apply"),
        1,
    ),
    # 5 sites in blocks of 2: three blocks, one Gram, constraint system and
    # solve each
    "blocked": (_blocked_fit, ("aggforce.gram", "aggforce.constraints", "aggforce.solve"), 3),
}


@pytest.mark.parametrize("kind", sorted(FITS))
def test_featurized_fit_nests_its_layers_in_the_entry(system, kind):
    fn, layers, n_grams = FITS[kind]
    out, spans = _recorded(lambda: fn(*system))
    names = _names(spans)
    assert names[0] == "aggforce.entry"
    assert names.count("aggforce.gram") == n_grams
    assert names.count("aggforce.constraints") == n_grams
    assert names.count("aggforce.solve") >= n_grams
    for sp in spans:
        if sp[0] in layers:
            assert _inside(sp, spans, "aggforce.entry"), sp
    assert set(layers) <= set(names)
    tmap = out["tmap"] if isinstance(out, dict) else out
    # the float64 host solve is entered only where a solve escalated
    assert ("aggforce.escalate" in names) == bool(tmap.force_map.tags["escalated"])


def test_default_project_forces_records_detection_and_the_linear_fit(system):
    coords, forces = system
    out, spans = _recorded(lambda: pt.project_forces(coords, forces, _cmap(), device="cpu"))
    assert out["constraints"] == GROUPS
    names = _names(spans)
    assert names[:2] == ["aggforce.entry", "aggforce.detect"]
    assert {"aggforce.gram", "aggforce.solve", "aggforce.apply"} <= set(names)
    # the linear fit is an entry of its own (qp_linear_map) inside project_forces
    assert names.count("aggforce.entry") == 2
    for sp in spans:
        if sp[0] != "aggforce.entry":
            assert _inside(sp, spans, "aggforce.entry"), sp
    (gram,) = [sp for sp in spans if sp[0] == "aggforce.gram"]
    inner_entry = [sp for sp in spans if sp[0] == "aggforce.entry"][1]
    assert inner_entry[1] <= gram[1] and gram[2] <= inner_entry[2]


ESCALATIONS = {
    "featurized": (_fused_fit, {"resid_tol": -1.0}),
    "blocked": (_blocked_fit, {"resid_tol": -1.0}),
    "linear": (_linear_fit, {"solver_args": {"resid_tol": 0.0}}),
}


@pytest.mark.parametrize("kind", sorted(ESCALATIONS))
def test_planted_escalation_records_the_escalate_span(system, kind):
    fn, kw = ESCALATIONS[kind]
    _, spans = _recorded(lambda: fn(*system, **kw))
    esc = [sp for sp in spans if sp[0] == "aggforce.escalate"]
    assert esc, _names(spans)
    for sp in esc:
        assert _inside(sp, spans, "aggforce.entry")
        # the host solve runs after the device solve it replaces
        solves = [s for s in spans if s[0] == "aggforce.solve" and s[2] <= sp[1]]
        assert solves


def test_span_never_calls_record_function_without_a_profiler(system, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    coords, forces = system
    pt.project_forces(coords, forces, _cmap(), device="cpu")
    _blocked_fit(coords, forces)
    with span("aggforce.solve"):
        pass
    # the patched function is the one a span enters under a profiler
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler active"):
            with span("aggforce.solve"):
                pass


def test_every_recorded_name_is_a_layer_span(system):
    coords, forces = system
    seen = set()
    for fn in (
        lambda: pt.project_forces(coords, forces, _cmap(), device="cpu"),
        lambda: _feat_project_forces(coords, forces),
        lambda: _blocked_fit(coords, forces, resid_tol=-1.0),
        lambda: _linear_fit(coords, forces, solver_args={"resid_tol": 0.0}),
    ):
        seen |= set(_names(_recorded(fn)[1]))
    assert seen == set(LAYER_SPANS)
    with pytest.raises(ValueError, match="aggforce.fit"):
        span("aggforce.fit")
