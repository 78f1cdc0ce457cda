"""Port parity: timed device staging (chunking, wire dtypes, report
accounting, retries) against the JAX package's staging."""

import numpy as np
import pytest
import torch

from aggforce_torch.io import staging as st
from aggforce_torch.io.staging import StagingReport, stage_arrays, stage_trajectory

import aggforce_tpu.io.staging as jst


def test_stage_arrays_reassembles_exactly():
    rng = np.random.default_rng(0)
    arrs = [
        rng.normal(size=(100, 7, 3)).astype(np.float32),
        rng.normal(size=(33, 5)).astype(np.float32),
    ]
    staged, report = stage_arrays(arrs, chunk_bytes=2048, device="cpu")
    _, jreport = jst.stage_arrays(arrs, chunk_bytes=2048)
    assert report.n_chunks == jreport.n_chunks > 2  # chunked as JAX chunks
    assert report.bytes == jreport.bytes == sum(a.nbytes for a in arrs)
    for host, dev in zip(arrs, staged):
        assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
        np.testing.assert_array_equal(dev.numpy(), host)


@pytest.mark.parametrize("wire", ["float16", "bfloat16"])
def test_stage_arrays_half_wire_error_bounded(wire):
    """A half-width wire halves the bytes; float16 keeps the relative error
    below 2e-3 (bfloat16's 8-bit mantissa below 1e-2), and the tensor is
    float32 on the device, as JAX's is."""
    rng = np.random.default_rng(1)
    arr = (100.0 * rng.normal(size=(64, 16, 3))).astype(np.float32)
    (dev,), report = stage_arrays([arr], wire_dtype=wire, device="cpu")
    (jdev,), _ = jst.stage_arrays([arr], wire_dtype=wire)
    assert report.wire_dtype == wire
    assert report.bytes == arr.nbytes // 2
    assert dev.dtype == torch.float32
    rel = np.abs(dev.numpy() - arr) / np.maximum(np.abs(arr), 1e-3)
    assert rel.max() < (2e-3 if wire == "float16" else 1e-2)
    # the same rounding as JAX's wire (round to nearest even)
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jdev))


def test_stage_trajectory_device_resident():
    rng = np.random.default_rng(2)
    coords = rng.normal(size=(50, 6, 3)).astype(np.float32)
    forces = rng.normal(size=(50, 6, 3)).astype(np.float32)
    traj, report = stage_trajectory(coords, forces, device="cpu")
    assert isinstance(traj.coords, torch.Tensor) and isinstance(traj.forces, torch.Tensor)
    np.testing.assert_array_equal(traj.forces.numpy(), forces)
    assert report.seconds > 0.0 and report.mbps > 0.0
    assert not report.degraded


def test_stage_trajectory_reads_the_wire_from_the_environment(monkeypatch):
    monkeypatch.setenv("AGGFORCE_WIRE_DTYPE", "float16")
    arr = np.ones((8, 4, 3), dtype=np.float32)
    _, report = stage_trajectory(arr, arr, device="cpu")
    assert report.wire_dtype == "float16" and report.bytes == arr.nbytes


def test_report_merge_accounting():
    """Field for field as the JAX package's merge."""
    kw_a = dict(seconds=1.0, bytes=10**6, n_chunks=2, retries=1, slow_chunks=1,
                chunk_mbps_min=5.0, chunk_mbps_max=50.0, chunk_seconds=[0.5, 0.5])
    kw_b = dict(seconds=2.0, bytes=3 * 10**6, n_chunks=3, chunk_mbps_min=30.0,
                chunk_mbps_max=90.0, chunk_seconds=[1.0])
    m = StagingReport(**kw_a).merge(StagingReport(**kw_b))
    jm = jst.StagingReport(**kw_a).merge(jst.StagingReport(**kw_b))
    assert m.seconds == 3.0 and m.bytes == 4 * 10**6
    assert m.n_chunks == 5 and m.retries == 1
    assert m.chunk_mbps_min == 5.0 and m.chunk_mbps_max == 90.0
    assert m.degraded  # a measured-slow chunk propagates through merge
    assert vars(m) == vars(jm)
    assert m.mbps == jm.mbps


def test_degraded_chunk_triggers_retry(monkeypatch):
    """A chunk that measures slow over a valid sample (the clock faked to
    1 s for 512 KB) is copied once more within budget, and flagged."""
    calls = {"n": 0}
    real_put = st._put_chunk

    def slow_put(chunk, device):
        calls["n"] += 1
        dev, _ = real_put(chunk, device)
        return dev, 1.0

    monkeypatch.setattr(st, "_put_chunk", slow_put)
    arr = np.zeros((64, 2048), np.float32)  # 512 KB
    (out,), report = st.stage_arrays([arr], chunk_bytes=1 << 30, max_retries=2, device="cpu")
    assert calls["n"] == 2  # one payload chunk + one retry
    assert report.retries == 1 and report.slow_chunks == 1
    assert report.degraded
    np.testing.assert_array_equal(out.numpy(), arr)


def test_retry_budget_is_shared_across_chunks(monkeypatch):
    calls = {"n": 0}
    real_put = st._put_chunk

    def slow_put(chunk, device):
        calls["n"] += 1
        return real_put(chunk, device)[0], 1.0

    monkeypatch.setattr(st, "_put_chunk", slow_put)
    arr = np.zeros((64, 2048), np.float32)
    _, report = st.stage_arrays([arr], chunk_bytes=1 << 16, max_retries=2, device="cpu")
    assert report.n_chunks == 8 and report.retries == 2
    assert calls["n"] == 10 and report.slow_chunks == 8


def test_fast_chunks_never_retry(monkeypatch):
    calls = {"n": 0}
    real_put = st._put_chunk

    def counting_put(chunk, device):
        calls["n"] += 1
        return real_put(chunk, device)

    monkeypatch.setattr(st, "_put_chunk", counting_put)
    arr = np.zeros((64, 256), np.float32)
    (_,), report = st.stage_arrays([arr], chunk_bytes=1 << 14, max_retries=2, device="cpu")
    assert calls["n"] == report.n_chunks
    assert report.retries == 0 and not report.degraded
