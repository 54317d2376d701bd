"""Fixtures of the benchmark's own tests: a small benchmark tree on the CPU.

``tiny_bench`` copies ``portbench/`` beside a ``BENCHMARK.json`` of its own
whose cells run at sizes a test holds: a random detector error model of 48
detectors and 260 mechanisms through the staged decoder, and a (120, 6, 3)
Gallager code through min-sum.  The harness runs them with ``allow_cpu``.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH.parent))

TINY_DEM = {
    "name": "tiny_dem", "source": "a random detector error model for tests",
    "code": {"kind": "dem", "file": "data/tiny_dem.npz", "sha256": None},
    "decoder": {"class": "StagedDemDecoder",
                "kwargs": {"gammas": [0.4], "stage0_iters": 16, "deep_iters": 40, "lam": 8,
                           "check_every": 8, "layout": "check", "dtype": "float32",
                           "hbm_bytes": 8 << 30}},
    "stated": {"gammas": [0.4], "stage0_iters": 16, "deep_iters": 40, "lam": 8, "lam3": 0,
               "check_every": 8, "alpha": 1.0, "relay_legs": 0, "dtype": "float32",
               "deep_dtype": "float32", "osd_rank": "abs_llr", "layout": "check"},
    "control": {"dtype": "bfloat16", "deep_dtype": "bfloat16"},
    "host_spans": {"osd": "_host_osd_pick"},
    "reference": "staged",
    "check": {"consistent": "all", "block_rows": 64, "limits": {"inconsistent": 0, "differ": 0}},
}
TINY_GALLAGER = {
    "name": "tiny_gallager", "source": "a small Gallager code for tests",
    "code": {"kind": "gallager", "n": 120, "wr": 6, "wc": 3, "rng": 5},
    "decoder": {"class": "MinSumDecoder", "kwargs": {"max_iters": 30}},
    "stated": {"max_iters": 30, "alpha": 1.0, "beta": 0.0, "damping": 0.0, "check_every": 1,
               "dtype": "float32"},
    "control": {"dtype": "bfloat16"},
    "host_spans": {},
    "reference": "minsum",
    "check": {"consistent": "converged", "block_rows": 256,
              "limits": {"inconsistent": 0, "differ": 0, "llr_gap": 1.0}},
}


def tiny_dem_arrays(seed: int = 3):
    rng = np.random.default_rng(seed)
    D, N = 48, 260
    A = np.zeros((D, N), np.uint8)
    for j in range(N):
        A[rng.choice(D, rng.integers(1, 4), replace=False), j] = 1
    O = (rng.random((3, N)) < 0.1).astype(np.uint8)
    priors = np.array([0.004, 0.01, 0.02, 0.03])[rng.integers(0, 4, N)]
    return A, O, priors


def write_tiny(root: Path) -> Path:
    """A benchmark tree under ``root``; returns its ``portbench`` directory."""
    bench = root / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    A, O, priors = tiny_dem_arrays()
    S = sp.csr_matrix(A)
    path = bench / "data" / "tiny_dem.npz"
    np.savez(path, data=S.data, indices=S.indices, indptr=S.indptr, shape=np.array(S.shape),
             priors=priors, obs=O)
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    dem = json.loads(json.dumps(TINY_DEM))
    dem["code"]["sha256"] = digest
    (bench / "configs" / "tiny_dem.json").write_text(json.dumps(dem))
    (bench / "configs" / "tiny_gallager.json").write_text(json.dumps(TINY_GALLAGER))
    traffic = {
        "tiny_dem_b64": {"channel": {"priors": {"file": "data/tiny_dem.npz", "sha256": digest}},
                         "batch": 64, "pool_batches": 4, "keep_share": 1.0,
                         "check_rows_per_call": 16, "trace_calls": 2},
        "tiny_bsc_b128": {"channel": {"per": 0.03}, "batch": 128, "pool_batches": 4,
                          "keep_share": 0.5, "check_rows_per_call": 32, "trace_calls": 3},
    }
    for name, t in traffic.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(t))
    workloads = [{"name": "tiny.dem", "config": "tiny_dem", "traffic": "tiny_dem_b64", "chips": 1,
                  "why": "tests"},
                 {"name": "tiny.bsc", "config": "tiny_gallager", "traffic": "tiny_bsc_b128",
                  "chips": 1, "why": "tests"}]
    doc = {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"], "run_seconds": 1,
        "configs": [{"name": c, "source": "tests", "file": f"portbench/configs/{c}.json",
                     "reduced": [], "why": "tests"} for c in ("tiny_dem", "tiny_gallager")],
        "workloads": workloads,
        "end_to_end": [
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"},
            {"name": "shots_per_s", "unit": "shots/s", "better": "higher", "bound": 0.05,
             "source": "host_clock", "workloads": ["tiny.dem"]},
            {"name": "syndromes_per_s", "unit": "syndromes/s", "better": "higher",
             "bound": 0.05, "source": "host_clock", "workloads": ["tiny.bsc"]},
            {"name": "decode_ms_p95", "unit": "ms", "better": "lower", "bound": 0.05,
             "source": "host_clock", "workloads": ["tiny.bsc"]}],
        "per_layer": [
            {"name": "osd_host_share.dem", "unit": "%", "better": "lower",
             "source": "program_span", "layer": "osd", "moves": "shots_per_s",
             "workloads": ["tiny.dem"]},
            {"name": "device_idle.gallager", "unit": "%", "better": "lower",
             "source": "device_trace", "layer": "device", "moves": "syndromes_per_s",
             "workloads": ["tiny.bsc"]}],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return bench


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    return write_tiny(tmp_path_factory.mktemp("bench"))
