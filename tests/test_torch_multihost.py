"""Port parity: the multi-process layer (parallel/multihost.py, parallel/staged.py
and ``FERSweep``'s multi-process sweep) on a spawned group of 2 gloo ranks.

The ranks meet at a ``FileStore`` in the test's directory (no ports) and each
prints one JSON line.  The sweep is the reference's own worker's
(tests/test_multihost.py): ``parity_check_matrix(48, 6, 3, rng=7)``, BP with
20 iterations at per 0.05, batch 16, seed 3, 40 trials and ``max_seconds``
300.  Its global counts must equal those of the JAX package's two-process
run of the same sweep (``jax.distributed`` on the CPU), which draws the same
numpy streams, keyed by ``(seed, point, step, rank)``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu_torch import harness as h

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PORT_WORKER = r"""
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, store, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu_torch.harness import FERSweep
from ldpcdecoders_tpu_torch.parallel import allreduce_counts, global_mesh, staged_local_eval

dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
out = {"rank": rank, "red": allreduce_counts({"x": rank + 1, "y": 10})}

H = pt.parity_check_matrix(48, 6, 3, rng=7)
factory = lambda per: pt.BeliefPropagationDecoder(H, per, 20, device="cpu")
sweep = FERSweep(H, factory, [0.05], batch=16, seed=3)
out["deferred"] = sweep.multihost
out["sweep"] = sweep.run(trials_per_point=40, max_seconds=300.0)[0.05]
out["detected"] = sweep.multihost

# a checkpoint on a filesystem that is not shared: rank 0 alone writes it,
# and a resumed sweep adopts rank 0's state on every rank
ck = os.path.join(tmp, f"ck{rank}.json")
FERSweep(H, factory, [0.05], batch=16, seed=3, checkpoint_path=ck).run(trials_per_point=32)
out["ck_written"] = os.path.exists(ck)
out["resumed"] = FERSweep(H, factory, [0.05], batch=16, seed=3, checkpoint_path=ck).run(
    trials_per_point=64)[0.05]
out["full"] = FERSweep(H, factory, [0.05], batch=16, seed=3).run(trials_per_point=64)[0.05]

# the stop vote: rank 1's budget is spent at once, rank 0's never; both stop
out["stopped"] = FERSweep(H, factory, [0.05], batch=16, seed=3).run(
    trials_per_point=64, max_seconds=1e9 if rank == 0 else 0.0)[0.05]

rng = np.random.default_rng(0)
A = (rng.random((40, 300)) < 0.08).astype(np.uint8)
A[:, A.sum(axis=0) == 0] = 1
pr = np.clip(rng.random(300) * 0.02, 1e-4, 0.02)
O = (rng.random((3, 300)) < 0.1).astype(np.uint8)
dec = pt.StagedDemDecoder(A, pr, observables=O, gammas=(0.3, (-0.24, 0.66)),
                          stage0_iters=16, deep_iters=64, lam=20, relay_legs=1, check_every=8,
                          device="cpu")
st = staged_local_eval(dec, 256, global_mesh(device="cpu"), seed=7, batch=128, deep_bucket=32)
out["staged"] = {k: st[k] for k in ("shots", "fails", "deep_shots", "osd_shots", "processes",
                                    "logical_ci95")}
out["staged"]["local_shots"] = st["local"]["shots"]
out["staged"]["local_fails"] = st["local"]["fails"]
print("RESULT " + json.dumps(out))
dist.destroy_process_group()
"""

_JAX_WORKER = r"""
import json, sys
import jax

pid, port = int(sys.argv[1]), sys.argv[2]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                           process_id=pid)
import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.harness import FERSweep

H = lt.parity_check_matrix(48, 6, 3, rng=7)
sweep = FERSweep(H, lambda per: lt.BeliefPropagationDecoder(H, per, 20), [0.05],
                 batch=16, seed=3)
print("RESULT " + json.dumps({"pid": pid,
                              "sweep": sweep.run(trials_per_point=40, max_seconds=300.0)[0.05]}))
"""

_TCP_WORKER = r"""
import json, sys
import torch

rank, port = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
from ldpcdecoders_tpu_torch.parallel import allreduce_counts, initialize_multihost

initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo")
initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo")  # already set up: a no-op
print("RESULT " + json.dumps({"rank": rank, "red": allreduce_counts({"x": rank + 1})}))
"""

COUNTS = ("trials", "ler", "ler_ci95", "syndrome_match_rate", "converged_fraction",
          "mean_iters")


def _results(procs, timeout=240):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][0]
            outs.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            p.kill()
    return outs


def _spawn(script, args_of, env):
    return [subprocess.Popen([sys.executable, str(script), *args_of(r)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]


@pytest.fixture(scope="module")
def port_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    (d / "worker.py").write_text(_PORT_WORKER)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    outs = _results(_spawn(d / "worker.py", lambda r: (str(r), str(d / "store"), str(d)), env))
    return sorted(outs, key=lambda o: o["rank"])


@pytest.fixture(scope="module")
def jax_sweep(tmp_path_factory):
    """The JAX package's two-process run of the same sweep."""
    d = tmp_path_factory.mktemp("multihost_jax")
    (d / "worker.py").write_text(_JAX_WORKER)
    port = _free_port()
    env = {"PATH": os.environ.get("PATH", ""), "HOME": os.environ.get("HOME", "/root"),
           "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    outs = _results(_spawn(d / "worker.py", lambda r: (str(r), str(port)), env))
    assert _counts(outs[0]["sweep"]) == _counts(outs[1]["sweep"])
    return outs[0]["sweep"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _counts(summary):
    return {k: summary[k] for k in COUNTS}


def test_allreduce_counts_sums_over_the_ranks(port_ranks):
    for o in port_ranks:
        assert o["red"] == {"x": 3, "y": 20}


def test_two_process_sweep_equals_the_jax_package(port_ranks, jax_sweep):
    for o in port_ranks:
        assert o["deferred"] is None and o["detected"] is True
        assert o["sweep"]["trials"] == 40
        assert _counts(o["sweep"]) == _counts(jax_sweep)


def test_checkpoint_written_by_rank_0_and_resumed(port_ranks):
    assert [o["ck_written"] for o in port_ranks] == [True, False]
    for o in port_ranks:
        assert o["resumed"]["trials"] == 64
        assert _counts(o["resumed"]) == _counts(o["full"])


def test_max_seconds_stop_is_agreed(port_ranks):
    a, b = (o["stopped"] for o in port_ranks)
    assert a["trials"] == b["trials"] == 0


def test_staged_local_eval_reduces_over_the_ranks(port_ranks):
    a, b = (o["staged"] for o in port_ranks)
    assert a == {**b, "local_shots": a["local_shots"], "local_fails": a["local_fails"]}
    for st in (a, b):
        assert st["processes"] == 2
        assert st["shots"] == 2 * st["local_shots"]
    assert a["fails"] == a["local_fails"] + b["local_fails"]


def test_one_process_sweep_decides_at_run():
    """``multihost`` is None after ``__init__`` (the group may be set up
    later) and False after a run in one process."""
    H = pt.parity_check_matrix(48, 6, 3, rng=7)
    sweep = h.FERSweep(H, lambda p: pt.BeliefPropagationDecoder(H, p, 20, device="cpu"),
                       [0.05], batch=16, seed=3)
    assert sweep.multihost is None
    sweep.run(trials_per_point=16)
    assert sweep.multihost is False
    assert h.FERSweep(H, None, [0.05], multihost=True).multihost is True


def test_initialize_multihost_over_tcp(tmp_path):
    """Two processes meet at rank 0's TCP address; a second call on a
    process that has its group is a no-op."""
    (tmp_path / "worker.py").write_text(_TCP_WORKER)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    outs = _results(_spawn(tmp_path / "worker.py", lambda r: (str(r), str(port)), env))
    assert [o["red"] for o in outs] == [{"x": 3}, {"x": 3}]


def test_single_process_identities():
    from ldpcdecoders_tpu_torch.parallel import allreduce_counts, initialize_multihost
    from ldpcdecoders_tpu_torch.parallel.multihost import broadcast_from_host0

    assert initialize_multihost() is None  # no coordinator: a no-op
    assert allreduce_counts({"b": 2, "a": 1}) == {"a": 1, "b": 2}
    v = np.array([1.5, 2.0])
    assert np.array_equal(broadcast_from_host0(v), v)
