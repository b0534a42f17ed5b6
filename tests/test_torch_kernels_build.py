"""The one-time kernel build (`kernels/_build.py`) under concurrent callers,
with a stand-in nvcc that records each call (no CUDA toolkit needed)."""

import concurrent.futures
import os
import stat
import sys

from mpc_collisionavoidance_tpu_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$FAKE_NVCC_LOG"
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
sleep 0.2
: > "$out"
"""


def test_concurrent_builds_run_nvcc_once_per_source(tmp_path, monkeypatch):
    """Eight threads ask for the library at once (a server's solve thread
    and its caller, say), with a short thread switch interval: nvcc runs
    once per source plus one link, and every caller gets the one library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "calls.log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            libs = [f.result(timeout=120) for f in
                    [pool.submit(_build.build) for _ in range(8)]]
    finally:
        sys.setswitchinterval(interval)
    assert len(set(libs)) == 1 and libs[0].is_file()
    calls = log.read_text().splitlines()
    n_sources = len(_build.sources()[0])
    assert sum(" -c " in f" {c} " for c in calls) == n_sources
    assert sum("-shared" in c for c in calls) == 1
    assert len(calls) == n_sources + 1
    assert os.path.dirname(libs[0]) == str(
        tmp_path / "build" / _build.source_hash())
