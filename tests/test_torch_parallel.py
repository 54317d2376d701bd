"""Port parity: parallel/ (SPMD decoding on torch.distributed).

One spawned group of 4 gloo ranks on the CPU (a ``FileStore`` in the test's
directory: no ports) builds the port's meshes, ``(data 4)`` and ``(data 2,
model 2)``, runs every case of tests/test_parallel.py once on inputs this
module draws, and each rank writes its outputs to npz.  They are held
against the JAX package's own ``parallel`` functions on its 8-virtual-device
CPU mesh (``(8,)`` and ``(4, 2)``: the same model axis of 2) and against the
unsharded decoders:

  * the batch-sharded BP, QC and mixed-channel decodes bitwise (each lane
    decodes alone);
  * the check-sharded min-sum's ``converged`` and ``iters`` equal, ``err``
    equal on converged lanes (the reference's own criterion);
  * the sum-product form at the reference test's thresholds;
  * the reference's errors for an indivisible batch, a QC batch that is not
    a multiple of the data axis, and erasures of the wrong shape.

Every rank must return the same (whole-batch) outputs.  A one-rank mesh
without a launcher is tested in this process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu import parallel as ref_par
from ldpcdecoders_tpu_torch import parallel as par

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

_WORKER = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, inp, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=120))
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu_torch import parallel as par

z = np.load(inp)
mesh4 = par.make_mesh(device="cpu")
mesh22 = par.make_mesh(axis_names=("data", "model"), shape=(2, 2), device="cpu")
res = {}


def error_of(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


H = z["code"]
bp = pt.BeliefPropagationDecoder(H, 0.02, 50, device="cpu")
res["bp_err"], res["bp_conv"] = par.sharded_batch_decode(bp, z["syn_bp"], mesh4)
res["indivisible"] = error_of(
    lambda: par.sharded_batch_decode(bp, np.zeros((7, H.shape[0])), mesh4))
bp1 = pt.BeliefPropagationDecoder(H, 0.01, 50, device="cpu")
res["st_err"], res["st_conv"], st = par.decode_with_stats(bp1, z["syn_st"], mesh4)
res["st_stats"] = json.dumps(st)
for key, g, per, syn in (("ms", pt.TannerGraph.from_pcm(H), 0.02, z["syn_ms"]),
                         ("tor", pt.TannerGraph.from_pcm(z["toric"]), 0.03, z["syn_tor"])):
    fn = par.make_check_sharded_minsum_fn(g, per, 50, mesh22)
    res[key + "_err"], res[key + "_conv"], res[key + "_iters"] = fn(syn)
fn = par.make_check_sharded_sumproduct_fn(pt.TannerGraph.from_pcm(H), 0.02, 50, mesh22)
res["sp_err"], res["sp_conv"], res["sp_iters"] = fn(z["syn_sp"])
gh = pt.TannerGraph.from_edges(z["hgp_rows"], z["hgp_cols"], int(z["hgp_m"]), int(z["hgp_n"]))
for key, maker in (("hgp_minsum", par.make_check_sharded_minsum_fn),
                   ("hgp_sumproduct", par.make_check_sharded_sumproduct_fn)):
    res[key + "_err"], res[key + "_conv"], res[key + "_iters"] = maker(gh, 0.001, 30, mesh22)(
        z["syn_hgp"])
qdec = pt.QCMinSumDecoder(z["qc_base"], 16, 0.04, 12, schedule="layered", device="cpu")
qfn = par.make_qc_sharded_decode_fn(qdec, mesh4)
res["qc_err"], res["qc_conv"], res["qc_iters"], res["qc_llrs"] = qfn(z["syn_qc"])
res["qc_error"] = error_of(lambda: qfn(z["syn_qc"][:10]))
mdec = pt.MixedChannelDecoder(z["mx_H"], 0.01, 30, osd_order=0, device="cpu")
res["mx_err"], res["mx_ok"] = par.sharded_mixed_decode(mdec, z["syn_mx"], z["eps_mx"], mesh4)
res["mx_error"] = error_of(
    lambda: par.sharded_mixed_decode(mdec, z["syn_mx"], z["eps_mx"][:, :5], mesh4))
np.savez(out, **res)
dist.destroy_process_group()
"""


def _syn(H, errs):
    return ((errs.astype(np.int64) @ np.asarray(H).T) % 2).astype(np.uint8)


@pytest.fixture(scope="module")
def inputs():
    """The cases' inputs, drawn from seeds as tests/test_parallel.py draws
    them."""
    code = lt.parity_check_matrix(240, 8, 4, rng=23)
    z = {"code": code}
    for key, seed, B, per in (("bp", 1, 32, 0.02), ("st", 2, 16, 0.01), ("ms", 3, 16, 0.02),
                              ("sp", 5, 16, 0.02)):
        z[f"errs_{key}"] = np.random.default_rng(seed).random((B, code.shape[1])) < per
        z[f"syn_{key}"] = _syn(code, z[f"errs_{key}"])
    z["toric"] = lt.toric_code_x(3)
    z["syn_tor"] = _syn(z["toric"], np.random.default_rng(4).random((8, 18)) < 0.03)
    # a hypergraph-product code as an edge list: 112,500 qubits, no dense H
    H1 = lt.parity_check_matrix(300, 6, 3, rng=7)
    (rows, cols, m, n), _ = lt.hypergraph_product_edges(H1, H1)
    import scipy.sparse as sp

    Hx = sp.coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(m, n)).tocsr()
    rng = np.random.default_rng(11)
    errs = np.zeros((8, n), np.int8)
    for b in range(8):  # weight-4 errors: well within BP's reach
        errs[b, rng.choice(n, size=4, replace=False)] = 1
    z.update(hgp_rows=rows, hgp_cols=cols, hgp_m=m, hgp_n=n,
             syn_hgp=np.asarray((Hx @ errs.T).T % 2, np.uint8))
    z["_Hx"] = Hx
    z["qc_base"] = lt.random_qc_base_matrix(6, 3, 2, 16, rng=5)
    Hq = lt.qc_lift(z["qc_base"], 16)
    z["syn_qc"] = _syn(Hq, np.random.default_rng(3).random((16, Hq.shape[1])) < 0.03)
    z["mx_H"] = lt.parity_check_matrix(120, 6, 3, rng=0)
    rng = np.random.default_rng(3)
    eps = rng.random((32, 120)) < 0.08
    e = np.where(eps, rng.random((32, 120)) < 0.5, rng.random((32, 120)) < 0.01)
    z.update(eps_mx=eps, syn_mx=_syn(z["mx_H"], e))
    return z


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Each rank's outputs of the 4-rank run."""
    d = tmp_path_factory.mktemp("parallel")
    np.savez(d / "in.npz", **{k: v for k, v in inputs.items() if not k.startswith("_")})
    (d / "worker.py").write_text(_WORKER)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(d / "worker.py"), str(r), str(WORLD),
                               str(d / "store"), str(d / "in.npz"), str(d / f"out{r}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
    finally:
        for p in procs:
            p.kill()
    return [dict(np.load(d / f"out{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def out(ranks):
    """Rank 0's outputs, after checking that every rank returned the same."""
    for other in ranks[1:]:
        assert other.keys() == ranks[0].keys()
        for k, v in ranks[0].items():
            assert np.array_equal(other[k], v), k
    return ranks[0]


def test_every_rank_returns_the_whole_batch(out, inputs):
    assert out["bp_err"].shape == (32, inputs["code"].shape[1])
    assert out["bp_err"].dtype == np.int8 and out["bp_conv"].dtype == bool
    assert out["ms_iters"].dtype == np.int32


def test_batch_sharded_bp_bitwise(out, inputs):
    H, syn = inputs["code"], inputs["syn_bp"]
    dec = lt.BeliefPropagationDecoder(H, 0.02, 50)
    want = ref_par.sharded_batch_decode(dec, syn, ref_par.make_mesh(8))
    assert np.array_equal(out["bp_err"], want[0]) and np.array_equal(out["bp_conv"], want[1])
    here = pt.BeliefPropagationDecoder(H, 0.02, 50, device="cpu").batch_decode(syn)
    assert np.array_equal(out["bp_err"], here[0]) and np.array_equal(out["bp_conv"], here[1])


def test_indivisible_batch_raises(out, inputs):
    dec = lt.BeliefPropagationDecoder(inputs["code"], 0.02, 10)
    with pytest.raises(ValueError) as ref:
        ref_par.sharded_batch_decode(dec, np.zeros((7, inputs["code"].shape[0])),
                                     ref_par.make_mesh(8))
    assert str(ref.value) == "batch 7 must divide the 'data' mesh size 8"
    assert str(out["indivisible"]) == "batch 7 must divide the 'data' mesh size 4"


def test_decode_with_stats(out, inputs):
    dec = lt.BeliefPropagationDecoder(inputs["code"], 0.01, 50)
    err, conv, want = ref_par.decode_with_stats(dec, inputs["syn_st"], ref_par.make_mesh(8))
    got = json.loads(str(out["st_stats"]))
    assert np.array_equal(out["st_err"], err) and np.array_equal(out["st_conv"], conv)
    assert got.keys() == want.keys()
    assert got["batch_size"] == want["batch_size"] == 16
    assert got["converged_fraction"] == want["converged_fraction"] == conv.mean()
    assert got["max_iters_used"] == want["max_iters_used"] >= 1
    assert got["mean_iters"] == pytest.approx(want["mean_iters"], rel=1e-6)


def _check_sharded_ref(maker, H_or_graph, per, iters, syn, shape=(4, 2)):
    graph = (H_or_graph if isinstance(H_or_graph, lt.TannerGraph)
             else lt.TannerGraph.from_pcm(H_or_graph))
    mesh = ref_par.make_mesh(8, axis_names=("data", "model"), shape=shape)
    return [np.asarray(a) for a in maker(graph, per, iters, mesh)(syn)]


def test_check_sharded_minsum_matches_reference(out, inputs):
    err, conv, iters = _check_sharded_ref(ref_par.make_check_sharded_minsum_fn,
                                          inputs["code"], 0.02, 50, inputs["syn_ms"])
    assert np.array_equal(out["ms_conv"], conv) and np.array_equal(out["ms_iters"], iters)
    assert np.array_equal(out["ms_err"][conv], err[conv])
    assert conv.mean() > 0.9
    # and the unsharded decoder's flags
    ref_err, ref_conv = lt.MinSumDecoder(inputs["code"], 0.02, 50).batch_decode(inputs["syn_ms"])
    assert np.array_equal(out["ms_conv"], ref_conv)
    assert np.array_equal(out["ms_err"][ref_conv], ref_err[ref_conv])


def test_check_sharded_minsum_padded_checks_are_inert(out, inputs):
    H, syn = inputs["toric"], inputs["syn_tor"]  # m = 9 over a model axis of 2
    err, conv, iters = _check_sharded_ref(ref_par.make_check_sharded_minsum_fn, H, 0.03, 50, syn)
    assert np.array_equal(out["tor_conv"], conv) and np.array_equal(out["tor_iters"], iters)
    assert np.array_equal(out["tor_err"][conv], err[conv])
    synhat = (out["tor_err"].astype(int) @ H.T) % 2
    for b in np.flatnonzero(out["tor_conv"]):
        assert np.array_equal(synhat[b], syn[b])


@pytest.mark.parametrize("form", ["minsum", "sumproduct"])
def test_check_sharded_dense_free_hgp(out, inputs, form):
    """A 112,500-qubit hypergraph-product code compiled from its edge list
    (no dense H anywhere), its checks sharded over the model axis."""
    err, conv = out[f"hgp_{form}_err"], out[f"hgp_{form}_conv"]
    assert conv.mean() > 0.9
    synhat = np.asarray((inputs["_Hx"] @ err.astype(np.int8).T).T % 2)
    for b in np.flatnonzero(conv):
        assert np.array_equal(synhat[b], inputs["syn_hgp"][b])
    graph = lt.TannerGraph.from_edges(inputs["hgp_rows"], inputs["hgp_cols"], inputs["hgp_m"],
                                      inputs["hgp_n"])
    assert graph.H is None
    maker = getattr(ref_par, f"make_check_sharded_{form}_fn")
    _, ref_conv, _ = _check_sharded_ref(maker, graph, 0.001, 30, inputs["syn_hgp"])
    assert np.array_equal(conv, ref_conv)


def test_check_sharded_sumproduct(out, inputs):
    H, syn, errs = inputs["code"], inputs["syn_sp"], inputs["errs_sp"]
    err, conv = out["sp_err"], out["sp_conv"]
    assert conv.mean() > 0.9
    synhat = (err.astype(int) @ H.T) % 2
    for b in np.flatnonzero(conv):
        assert np.array_equal(synhat[b], syn[b])
    assert (err[conv].astype(bool) == errs[conv]).all(axis=1).mean() > 0.8
    _, ref_conv, _ = _check_sharded_ref(ref_par.make_check_sharded_sumproduct_fn, H, 0.02, 50,
                                        syn)
    assert np.array_equal(conv, ref_conv)


def test_qc_sharded_bitwise(out, inputs):
    import jax

    base, syn = inputs["qc_base"], inputs["syn_qc"]
    dec = lt.QCMinSumDecoder(base, 16, 0.04, 12, schedule="layered", backend="pallas",
                             interpret=True, batch_tile=2)
    fn = ref_par.make_qc_sharded_decode_fn(dec, ref_par.make_mesh(8))
    want = [np.asarray(a) for a in jax.block_until_ready(fn(syn))]
    for k, w in zip(("err", "conv", "iters"), want):
        assert np.array_equal(out[f"qc_{k}"], w), k
    np.testing.assert_allclose(out["qc_llrs"], want[3])
    here = pt.QCMinSumDecoder(base, 16, 0.04, 12, schedule="layered",
                              device="cpu").batch_decode_detailed(syn)
    for k, w in zip(("err", "conv", "iters"), here[:3]):
        assert np.array_equal(out[f"qc_{k}"], w), k
    assert np.array_equal(out["qc_llrs"], here[3]["llrs"])
    with pytest.raises(ValueError, match="multiple of"):
        fn(syn[:10])
    assert "multiple of data-mesh size (4) x batch_tile (1)" in str(out["qc_error"])


def test_mixed_sharded_bitwise(out, inputs):
    H, syn, eps = inputs["mx_H"], inputs["syn_mx"], inputs["eps_mx"]
    dec = lt.MixedChannelDecoder(H, 0.01, 30, osd_order=0)
    want = ref_par.sharded_mixed_decode(dec, syn, eps, ref_par.make_mesh(8))
    assert np.array_equal(out["mx_err"], want[0]) and np.array_equal(out["mx_ok"], want[1])
    here = pt.MixedChannelDecoder(H, 0.01, 30, osd_order=0, device="cpu").batch_decode(syn, eps)
    assert np.array_equal(out["mx_err"], here[0]) and np.array_equal(out["mx_ok"], here[1])
    assert str(out["mx_error"]).startswith("expected erasures of shape [B=32, 120]")


@pytest.fixture
def one_rank():
    """A one-rank gloo group that ``make_mesh`` sets up itself, torn down
    after the test."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield
    dist.destroy_process_group()


def test_one_rank_mesh_without_a_launcher(one_rank, inputs):
    mesh = par.make_mesh(device="cpu")
    assert tuple(mesh.mesh_dim_names) == ("data",) and mesh.size() == 1
    mesh2 = par.make_mesh(axis_names=("data", "model"), device="cpu")
    assert tuple(mesh2.mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="world of 1"):
        par.make_mesh(2, device="cpu")
    sh = par.batch_sharding(mesh, 2)
    assert (sh.parts, sh.index, sh.bounds(10)) == (1, 0, slice(0, 10))
    t = par.shard_batch(np.arange(12).reshape(6, 2), mesh)
    assert isinstance(t, torch.Tensor) and t.shape == (6, 2) and t.device.type == "cpu"
    H, syn = inputs["code"], inputs["syn_ms"]
    dec = pt.MinSumDecoder(H, 0.02, 50, device="cpu")
    e0, c0, i0, _, _ = dec.batch_decode_detailed(syn)
    e, c, i = par.make_check_sharded_minsum_fn(dec.graph, 0.02, 50, mesh2)(syn)
    # one model shard: the unsharded decoder's iteration, bitwise
    assert np.array_equal(e, e0) and np.array_equal(c, c0) and np.array_equal(i, i0)
    g, cv = par.sharded_batch_decode(dec, syn, mesh)
    assert np.array_equal(g, e0) and np.array_equal(cv, c0)
    assert par.allreduce_counts({"x": 3}) == {"x": 3}
    assert np.array_equal(par.multihost.broadcast_from_host0(np.arange(3.0)), np.arange(3.0))


@pytest.mark.parametrize("hbm_bytes", [60_000_000, 80_000_000_000])
def test_sharded_staged_decode_on_one_rank(one_rank, hbm_bytes, monkeypatch):
    """The staged decoder through ``sharded_staged_decode`` on a one-rank
    mesh, stage 0 in two chunks (a 60 MB budget carries 256 lanes a decode)
    and in one, bitwise the JAX package's decoder at the same budget, run
    op by op.  At 60 MB the reference runs its tail once a chunk, the port
    once on the whole batch; lanes decode independently, so the bits agree.
    Also bitwise the port's own ``batch_decode_detailed``."""
    import jax
    from ldpcdecoders_tpu.models.staged import StagedDemDecoder as RefStaged
    from ldpcdecoders_tpu.utils import hbm as ref_hbm
    from ldpcdecoders_tpu_torch.utils import hbm
    from test_torch_staged import chunk_case

    monkeypatch.setattr(ref_hbm, "_HEADROOM", hbm._HEADROOM)
    A, pr, _, det, kw = chunk_case()
    dec = pt.StagedDemDecoder(A, pr, hbm_bytes=hbm_bytes, device="cpu", **kw)
    err, solved = par.sharded_staged_decode(dec, det, par.make_mesh(device="cpu"))
    with jax.disable_jit():
        ref = RefStaged(A, pr, hbm_bytes=hbm_bytes, **kw)
        want_err, want_solved = ref.batch_decode_detailed(det)[:2]
    assert dec._max_stage0_batch == ref._max_stage0_batch
    assert (dec._max_stage0_batch < det.shape[0]) == (hbm_bytes == 60_000_000)
    assert not want_solved.all()  # the tail runs: deep buckets and the host OSD
    assert np.array_equal(err, want_err) and np.array_equal(solved, want_solved)
    one = dec.batch_decode_detailed(det)
    assert np.array_equal(err, one[0]) and np.array_equal(solved, one[1])


def test_batch_sharding_splits_in_rank_order():
    from ldpcdecoders_tpu_torch.parallel.mesh import BatchSharding

    parts = [BatchSharding("data", r, 4, 2).bounds(32) for r in range(4)]
    assert [(s.start, s.stop) for s in parts] == [(0, 8), (8, 16), (16, 24), (24, 32)]
    with pytest.raises(ValueError, match="batch 30 must divide the 'data' mesh size 4"):
        BatchSharding("data", 0, 4, 2).bounds(30)
