"""Trace reduction (utils/profiling.device_busy) on small recorded
GPU-shaped traces, and the GPU gate of the measuring entry points."""

import subprocess
import sys
from pathlib import Path

import jax
import pytest

from another_raytracer.utils import profiling

REPO = Path(__file__).resolve().parents[1]


def _xspace(gpu_lines, host=True):
    """Text-proto XSpace: one /device:GPU:0 plane whose lines hold
    (name, start_ns, dur_ns) events, plus a host plane."""
    names = sorted({n for _, evs in gpu_lines for n, _, _ in evs})
    mid = {n: i + 1 for i, n in enumerate(names)}
    lines = []
    for li, (lname, evs) in enumerate(gpu_lines):
        body = " ".join(
            f"events {{ metadata_id: {mid[n]} offset_ps: {s * 1000} "
            f"duration_ps: {d * 1000} }}" for n, s, d in evs)
        lines.append(f'lines {{ id: {li + 1} name: "{lname}" '
                     f"timestamp_ns: 0 {body} }}")
    meta = " ".join(f'event_metadata {{ key: {i} value {{ id: {i} '
                    f'name: "{n}" }} }}' for n, i in mid.items())
    txt = (f'planes {{ id: 1 name: "/device:GPU:0" {" ".join(lines)} '
           f"{meta} }}")
    if host:
        txt += (' planes { id: 2 name: "/host:CPU" lines { id: 1 '
                'name: "python" timestamp_ns: 0 events { metadata_id: 1 '
                'offset_ps: 0 duration_ps: 999000000 } } event_metadata '
                '{ key: 1 value { id: 1 name: "py" } } }')
    return jax.profiler.ProfileData.from_text_proto(txt)


def test_union_of_busy_intervals():
    # Two streams overlap on [30, 40); a gap [60, 100) is idle.
    prof = _xspace([
        ("Stream #13(compute)", [("mega_forward", 0, 40), ("fusion", 100, 20)]),
        ("Stream #14(compute)", [("fusion", 30, 30)]),
    ])
    r = profiling.device_busy(prof)
    assert r["window_s"] == pytest.approx(120e-9)
    assert r["busy_s"] == pytest.approx(80e-9)
    assert r["idle_share"] == pytest.approx(40 / 120)
    assert r["kernel_s"]["mega_forward"] == pytest.approx(40e-9)
    assert r["kernel_s"]["fusion"] == pytest.approx(50e-9)


def test_derived_lines_ignored_when_streams_exist():
    # A module-level span covers the idle gap; the stream events do not.
    prof = _xspace([
        ("XLA Modules", [("jit_step", 0, 100)]),
        ("Stream #7", [("k1", 0, 10), ("k2", 90, 10)]),
    ])
    r = profiling.device_busy(prof)
    assert r["busy_s"] == pytest.approx(20e-9)
    assert r["idle_share"] == pytest.approx(0.8)
    assert "jit_step" not in r["kernel_s"]


def test_no_device_events_raises():
    prof = _xspace([("Stream #1", [])])
    with pytest.raises(ValueError, match="no GPU device events"):
        profiling.device_busy(prof)


def test_cpu_trace_raises(tmp_path):
    # A trace taken on the CPU has no GPU plane: the reduction refuses it
    # rather than reporting a device time of zero.
    with profiling.trace(str(tmp_path)):
        jax.block_until_ready(jax.numpy.ones(8) * 2)
    with pytest.raises(ValueError):
        profiling.device_busy_logdir(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        profiling.device_busy_logdir(str(tmp_path / "empty"))


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit) as e:
        profiling.require_gpu()
    assert e.value.code != 0


def test_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert profiling.card_info().startswith("nvidia-smi unavailable")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_points_fail_without_gpu(script):
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "HOME": str(REPO)}
    r = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    # In a directory holding chip_smoke.py and nothing else of the repo.
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
