"""Port parity: the constraint finder against the JAX package's."""

from contextlib import contextmanager

import numpy as np
import pytest
import torch

from aggforce_torch.constraints import finder as pfind
from aggforce_torch.utils.synth import synthesize_trajectory

from aggforce_tpu.constraints import finder as jfind


def _both(xyz, **kw):
    """(JAX result, port result on numpy input, port result on a CPU tensor)."""
    expect = jfind.guess_pairwise_constraints(xyz, **kw)
    cross = kw.pop("cross_xyz", None)
    got = pfind.guess_pairwise_constraints(xyz, cross_xyz=cross, device="cpu", **kw)
    got_t = pfind.guess_pairwise_constraints(
        torch.as_tensor(xyz),
        cross_xyz=None if cross is None else torch.as_tensor(cross),
        **kw,
    )
    return expect, got, got_t


@contextmanager
def tf32_on(api):
    """TF32 products allowed for the whole process, through torch's legacy
    switch or its newer one; the default (off) is restored on exit."""
    matmul = torch.backends.cuda.matmul
    try:
        if api == "legacy":
            torch.set_float32_matmul_precision("high")
        else:
            matmul.fp32_precision = "tf32"
        yield
    finally:
        if api == "legacy":
            torch.set_float32_matmul_precision("highest")
        else:
            matmul.fp32_precision = "ieee"


def _rigid_pairs(seed, n_frames=240, n=12, pairs=((0, 1), (4, 5))):
    """Floppy sites with ``pairs`` moving rigidly, float32."""
    rng = np.random.default_rng(seed)
    base = rng.normal(scale=0.8, size=(n, 3))
    coords = (base[None] + 0.05 * rng.normal(size=(n_frames, n, 3))).astype(np.float32)
    for k, (i, j) in enumerate(pairs):
        offset = np.zeros(3, np.float32)
        offset[k % 3] = 0.15 + 0.05 * k
        coords[:, j] = coords[:, i] + offset
    return coords


@pytest.mark.parametrize("seed", [0, 1])
def test_self_detection_matches_jax(seed):
    coords = _rigid_pairs(seed)
    expect, got, got_t = _both(coords, threshold=1e-3)
    assert expect == {frozenset((0, 1)), frozenset((4, 5))}
    assert got == expect and got_t == expect


def test_cross_detection_matches_jax():
    rng = np.random.default_rng(4)
    coords = rng.normal(size=(40, 4, 3))
    other = rng.normal(size=(40, 2, 3))
    other[:, 1, :] = coords[:, 2, :] + np.array([0.0, 0.2, 0.0])
    expect, got, got_t = _both(coords, cross_xyz=other, threshold=1e-3)
    assert expect == {(1, 2)}
    assert got == expect and got_t == expect


def test_ragged_tail_matches_jax(monkeypatch):
    """Frames past the last full chunk count in both packages: pair (2, 3)
    breaks rigidity only in the last frame."""
    rng = np.random.default_rng(0)
    n_frames, n_sites = 67, 8  # 67 = 4 * 16 + 3
    base = rng.normal(size=(n_sites, 3))
    coords = base[None] + 1e-6 * rng.normal(size=(n_frames, n_sites, 3))
    coords[:, 1] = coords[:, 0] + np.array([1.0, 0.0, 0.0])
    coords[:, 3] = coords[:, 2] + np.array([0.0, 1.0, 0.0])
    coords[-1, 3] += np.array([0.0, 0.5, 0.0])
    coords = coords.astype(np.float32)
    monkeypatch.setattr(jfind, "_frame_chunk", lambda n_a, n_b: 16)
    monkeypatch.setattr(pfind, "_frame_chunk", lambda n_a, n_b: 16)
    assert pfind._chunk_length(n_frames, n_sites, n_sites) == 17
    expect, got, got_t = _both(coords, threshold=1e-3)
    assert frozenset((0, 1)) in expect and frozenset((2, 3)) not in expect
    assert got == expect and got_t == expect


def test_far_from_origin_matches_jax():
    """100 nm off the origin, shifted differently per frame: the per-frame
    centroid centering keeps the Gram-trick distances at molecular
    precision in both packages."""
    rng = np.random.default_rng(8)
    n_frames, n = 200, 8
    base = rng.normal(scale=0.4, size=(n, 3))
    coords = base[None] + rng.normal(scale=0.05, size=(n_frames, n, 3))
    coords[:, 1] = coords[:, 0] + np.array([0.1, 0.0, 0.0])
    shift = 100.0 + rng.normal(scale=5.0, size=(n_frames, 1, 3))
    far = (coords + shift).astype(np.float32)
    expect, got, got_t = _both(far, threshold=1e-3)
    assert frozenset((0, 1)) in expect
    assert got == expect and got_t == expect
    near = pfind.guess_pairwise_constraints(coords.astype(np.float32), device="cpu")
    assert got == near


def test_synthetic_fixture_matches_jax():
    """The 60-atom synthetic system: exactly its 10 pairs, in both packages."""
    base = np.random.default_rng(5).normal(scale=0.5, size=(60, 3))
    groups = {frozenset((i, i + 1)) for i in range(0, 20, 2)}
    coords, _ = synthesize_trajectory(base, groups, 300, seed=9)
    expect, got, got_t = _both(coords)
    assert expect == groups
    assert got == expect and got_t == expect


@pytest.mark.parametrize("n_folds", [3, 4])
def test_fold_probe_matches_jax(n_folds):
    coords = _rigid_pairs(0)
    frames = np.arange(len(coords))
    np.random.default_rng(1).shuffle(frames)
    folds = np.array_split(frames, n_folds)
    expect = jfind.fold_train_constraint_probe(coords, folds)
    got = pfind.fold_train_constraint_probe(coords, folds, device="cpu")
    assert expect is not None
    assert got == expect
    # and each prediction is what detection on the training frames finds
    for held, pred in zip(folds, got):
        train = np.setdiff1d(np.arange(len(coords)), held)
        assert pred == pfind.guess_pairwise_constraints(coords[train], device="cpu")


def test_fold_probe_near_threshold_is_none_in_both():
    rng = np.random.default_rng(1)
    n_frames, n = 120, 6
    coords = rng.normal(scale=0.5, size=(n_frames, n, 3)).astype(np.float32)
    coords[:, 1] = coords[:, 0]
    coords[:, 1, 0] += 0.3 + 1e-3 * rng.normal(size=n_frames).astype(np.float32)
    folds = np.array_split(np.arange(n_frames), 3)
    assert jfind.fold_train_constraint_probe(coords, folds, margin_rel=0.2) is None
    assert (
        pfind.fold_train_constraint_probe(coords, folds, margin_rel=0.2, device="cpu")
        is None
    )


def test_distance_sd_matches_jax_moments():
    """The streamed sd matrix itself, ragged chunks included."""
    import jax.numpy as jnp

    coords = _rigid_pairs(3, n_frames=50, n=7)
    coords = coords - coords.mean(axis=1, keepdims=True)
    expect = np.asarray(
        jfind._distance_sd(
            jnp.asarray(coords), jnp.asarray(coords), jnp.ones(50), cross=False
        )
    )
    x = torch.as_tensor(coords)
    got = pfind._distance_sd(x, x, chunk=8).numpy()  # 50 = 6 * 8 + 2
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("api", ["legacy", "new"])
def test_detection_takes_no_matmul_under_process_tf32(monkeypatch, api):
    """With TF32 switched on for the process, detection still finds exactly
    the synthesized pairs: its distances take no matmul that TF32 could
    round (a matmul here fails the test)."""
    base = np.random.default_rng(5).normal(scale=0.5, size=(60, 3))
    groups = {frozenset((i, i + 1)) for i in range(0, 20, 2)}
    coords, _ = synthesize_trajectory(base, groups, 300, seed=9)

    def no_matmul(*args, **kwargs):
        raise AssertionError("the finder's distances took a matmul")

    with tf32_on(api):
        monkeypatch.setattr(torch, "matmul", no_matmul)
        got = pfind.guess_pairwise_constraints(coords, device="cpu")
        probe = pfind.fold_train_constraint_probe(
            coords, np.array_split(np.arange(300), 3), device="cpu"
        )
    assert got == groups
    assert probe == [groups] * 3


def test_cpu_and_numpy_inputs_take_the_plain_path(monkeypatch):
    """Numpy and CPU tensors never reach the card kernel (its launch count
    stays 0), and their masks are the plain moments' bit for bit, within
    one system and across two."""

    def no_kernel():
        raise AssertionError("a CPU input reached the card kernel")

    monkeypatch.setattr(pfind, "_pair_moments_lib", no_kernel)
    monkeypatch.setattr(pfind.pair_moments, "launches", 0)
    coords = _rigid_pairs(2)
    rng = np.random.default_rng(6)
    jitter = rng.normal(scale=1e-2, size=(len(coords), 4, 3)).astype(np.float32)
    other = coords[:, 3:7] + jitter
    other[:, 2] = coords[:, 9] + np.float32([0.0, 0.0, 0.25])
    cpu = torch.device("cpu")
    centroid = coords.mean(axis=1, keepdims=True)
    x = pfind._centered(coords, centroid, cpu)
    o = pfind._centered(other, centroid, cpu)
    t, n = x.shape[:2]

    def plain(a, b, cross):
        hits = pfind._distance_sd(a, b, pfind._chunk_length(t, n, b.shape[1])) < 1e-3
        if not cross:
            hits.fill_diagonal_(False)
        return hits.numpy()

    for a, b, cross in ((x, x, False), (x, o, True)):
        chunk = pfind._chunk_length(t, n, b.shape[1])
        got = pfind._constraint_mask(a, b, 1e-3, cross, chunk)
        assert got.dtype == np.bool_ and np.array_equal(got, plain(a, b, cross))
    ii, jj = np.nonzero(plain(x, x, False))
    within = {frozenset(p) for p in zip(ii.tolist(), jj.tolist())}
    ii, jj = np.nonzero(plain(x, o, True))
    across = {(int(i), int(j)) for i, j in zip(ii, jj)}
    assert within == {frozenset((0, 1)), frozenset((4, 5))} and (2, 9) in across
    for arr, cross in ((coords, other), (torch.as_tensor(coords), torch.as_tensor(other))):
        assert pfind.guess_pairwise_constraints(arr, device="cpu") == within
        found = pfind.guess_pairwise_constraints(arr, cross_xyz=cross, device="cpu")
        assert found == across
    assert pfind.pair_moments.launches == 0


@pytest.mark.parametrize(
    "bad",
    ["float64", "strided", "frames", "rank", "cpu", "other_float64", "other_strided",
     "xy_only", "no_frames"],
)
def test_kernel_wrapper_refuses_inputs_outside_its_contract(monkeypatch, bad):
    """The card kernel's wrapper raises on what the kernel does not take,
    before any launch, rather than falling back to the plain path: a
    float64 or non-contiguous input (either side), unequal frame counts, a
    wrong rank or a last axis other than xyz, no frames, a tensor off the
    card."""

    def no_kernel():
        raise AssertionError("the wrapper launched on inputs it must refuse")

    monkeypatch.setattr(pfind, "_pair_moments_lib", no_kernel)
    x = torch.zeros((16, 5, 3))
    other = None
    match = {"float64": "float32", "strided": "contiguous", "frames": "frames",
             "rank": r"\(T >= 1", "cpu": "CUDA", "other_float64": "other must be float32",
             "other_strided": "other must be contiguous", "xy_only": r"\(T >= 1",
             "no_frames": r"\(T >= 1"}[bad]
    if bad == "float64":
        x = x.double()
    elif bad == "strided":
        x = torch.zeros((5, 16, 3)).transpose(0, 1)
    elif bad == "frames":
        other = torch.zeros((15, 4, 3))
    elif bad == "rank":
        x = torch.zeros((16, 15))
    elif bad == "other_float64":
        other = torch.zeros((16, 4, 3), dtype=torch.float64)
    elif bad == "other_strided":
        other = torch.zeros((4, 16, 3)).transpose(0, 1)
    elif bad == "xy_only":
        x = torch.zeros((16, 5, 2))
    elif bad == "no_frames":
        x = torch.zeros((0, 5, 3))
    with pytest.raises(ValueError, match=match):
        pfind.pair_moments(x, other)


@pytest.mark.parametrize("threshold", [1e-4, 1e-3, 1e-2])
def test_plain_path_follows_the_threshold_like_jax(threshold):
    """The CPU path keeps the JAX package's threshold rule at thresholds
    around the default: the rigid pairs (sd at rounding level) are found,
    the floppy ones (sd ~0.07) are not."""
    coords = _rigid_pairs(2)
    expect, got, got_t = _both(coords, threshold=threshold)
    assert expect == {frozenset((0, 1)), frozenset((4, 5))}
    assert got == expect and got_t == expect


@pytest.mark.parametrize("n_other", [3, 20])
def test_cross_detection_with_more_or_fewer_sites_matches_jax(n_other):
    """Cross mode on the CPU with the other system smaller and larger than
    ``xyz``: the ordered (other, xyz) pairs equal the JAX package's."""
    coords = _rigid_pairs(3, n_frames=120)
    rng = np.random.default_rng(10 + n_other)
    other = (coords[:, :1] + 0.3 * rng.normal(size=(120, n_other, 3))).astype(np.float32)
    other[:, n_other - 1] = coords[:, 7] + np.float32([0.0, 0.0, 0.3])
    expect, got, got_t = _both(coords, cross_xyz=other, threshold=1e-3)
    assert expect == {(n_other - 1, 7)}
    assert got == expect and got_t == expect
