"""Port parity: the native (C++) host tier.

``ldpcdecoders_tpu_torch.native`` builds its own copy of the reference's
C++ sources with g++ (into the package's ``_kernels/``) and binds the same
entry points.  Every entry point is held bitwise against
``ldpcdecoders_tpu.native`` on the same seeded inputs, and the host OSD-0 /
OSD-CS also against the port's own batched plain OSD (ops/gf2.py) on the
same column order, which is how the host route of the decoders stands in
for the elimination kernels.
"""

import ctypes
import functools
import pathlib
import re
import subprocess

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ldpcdecoders_tpu.native as ref_native
import ldpcdecoders_tpu_torch.native as native
from ldpcdecoders_tpu_torch.ops import gf2 as port_gf2

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.native_available(), "g++ could not build the port's native library"
    assert ref_native.native_available()


def random_H(rng, m, n, dens):
    return (rng.random((m, n)) < dens).astype(np.uint8)


def test_library_builds_beside_the_package():
    path = native._library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parent.name == "ldpcdecoders_tpu_torch"
    assert sorted(p.name for p in native._SRCS) == [
        "gf2_host.cpp", "gf2_osd.cpp", "graph_compiler.cpp"]
    for src in native._SRCS:
        ref_src = ref_native._SRCS[[p.endswith(src.name) for p in ref_native._SRCS].index(True)]
        port, ref = src.read_text(), open(ref_src).read()
        if src.name == "gf2_osd.cpp":
            # the port adds the shared-order OSD-CS and the sweep's popcount
            # clones; the reference's entry points stay, held bitwise below
            assert set(entry_points(ref)) < set(entry_points(port))
        else:  # the reference's C++, comments aside
            assert code_of(port) == code_of(ref)


def entry_points(cpp: str) -> list[str]:
    """The names of a C++ source's ``extern "C"`` functions."""
    blocks = re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', cpp, re.S)
    return [name for b in blocks for name in re.findall(r"^\w[\w\s*]* (\w+)\(", b, re.M)]


def code_of(cpp: str) -> list[str]:
    """A C++ source's lines without ``//`` comments and blank lines."""
    lines = (line.split("//", 1)[0].rstrip() for line in cpp.splitlines())
    return [line for line in lines if line]


@pytest.mark.parametrize("m,n,dens", [(30, 60, 0.1), (64, 200, 0.05), (7, 9, 0.6)])
def test_compile_tanner_native_matches_reference(m, n, dens):
    H = random_H(np.random.default_rng(m + n), m, n, dens)
    H[0, :] = 1  # a full row: the padded maximum is reached
    dc, dv = int(H.sum(1).max()), int(H.sum(0).max()) + 1
    want = ref_native.compile_tanner_native(H, dc, dv)
    got = native.compile_tanner_native(H, dc, dv)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(want, got))
    with pytest.raises(ValueError, match="degree exceeds"):
        native.compile_tanner_native(H, dc - 1, dv)


@pytest.mark.parametrize("rows,n", [(5, 1), (17, 64), (33, 130)])
def test_pack_and_syndromes_match_reference(rows, n):
    rng = np.random.default_rng(rows * n)
    M = random_H(rng, rows, n, 0.4)
    assert np.array_equal(native.pack_gf2_rows(M), ref_native.pack_gf2_rows(M))
    assert np.array_equal(native.gf2_pack_cols(M), ref_native.gf2_pack_cols(M))
    E = random_H(rng, 11, n, 0.2)
    Hp, Ep = native.pack_gf2_rows(M), native.pack_gf2_rows(E)
    got = native.gf2_syndromes_packed(Hp, Ep, rows)
    assert np.array_equal(got, ref_native.gf2_syndromes_packed(Hp, Ep, rows))
    assert np.array_equal(got, (E.astype(np.int64) @ M.T) % 2)
    G = E.copy()
    G[::2, 0] ^= 1
    Gp = native.pack_gf2_rows(G)
    for a, b in zip(native.gf2_verify_packed(Hp, Ep, Gp),
                    ref_native.gf2_verify_packed(Hp, Ep, Gp)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="packed H shape"):
        native.gf2_syndromes_packed(Hp, Ep, rows + 1)


def osd_inputs(seed, B, m, n, dens):
    """A system, per-lane column orders, BP decisions and syndromes (some
    lanes outside the column span)."""
    rng = np.random.default_rng(seed)
    H = random_H(rng, m, n, dens)
    x = (rng.random((B, n)) < 0.15).astype(np.uint8)
    syn = ((x.astype(np.int64) @ H.T) % 2).astype(np.uint8)
    syn[0] = rng.random(m) < 0.5
    bp = (rng.random((B, n)) < 0.15).astype(np.uint8)
    order = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32)
    return H, order, bp, syn


@pytest.mark.parametrize("seed,m,n,dens", [(1, 20, 60, 0.2), (2, 40, 90, 0.1), (3, 33, 34, 0.3)])
def test_gf2_osd0_host_matches_reference(seed, m, n, dens):
    H, order, bp, syn = osd_inputs(seed, 6, m, n, dens)
    Hc = native.gf2_pack_cols(H)
    out, cons = native.gf2_osd0_host(Hc, m, order, bp, syn)
    want, wcons = ref_native.gf2_osd0_host(Hc, m, order, bp, syn)
    assert np.array_equal(out, want) and np.array_equal(cons, wcons)
    # the port's plain OSD-0 on the same order (sorted, packed systems)
    Ht = torch.stack([port_gf2.pack_bits(torch.as_tensor(H[:, o])) for o in order]).transpose(1, 2)
    resid = torch.as_tensor((syn ^ ((bp.astype(np.int64) @ H.T) % 2)).astype(np.int32))
    bps = torch.as_tensor(np.take_along_axis(bp, order, 1).astype(np.int32))
    corr = port_gf2.gf2_osd0(Ht.contiguous(), resid, bps, n).numpy()
    dev = np.zeros_like(out)
    np.put_along_axis(dev, order, corr.astype(np.uint8), 1)
    assert np.array_equal(dev, out)


@pytest.mark.parametrize("lam,lam3", [(0, 0), (6, 0), (12, 0), (8, 5), (12, 12)])
def test_gf2_osd_cs_host_matches_reference(lam, lam3):
    H, order, bp, syn = osd_inputs(10 + lam + lam3, 6, 24, 70, 0.15)
    Hc = native.gf2_pack_cols(H)
    out, cons = native.gf2_osd_cs_host(Hc, 24, lam, order, bp, syn, lam3=lam3)
    want, wcons = ref_native.gf2_osd_cs_host(Hc, 24, lam, order, bp, syn, lam3=lam3)
    assert np.array_equal(out, want) and np.array_equal(cons, wcons)
    assert cons[1:].all()
    if lam3 == 0:  # the device sweep's semantics: the port's plain OSD-CS
        Ht = torch.stack([port_gf2.pack_bits(torch.as_tensor(H[:, o]))
                          for o in order]).transpose(1, 2).contiguous()
        bps = torch.as_tensor(np.take_along_axis(bp, order, 1).astype(np.int32))
        corr = port_gf2.gf2_osd_cs(Ht, bps, torch.as_tensor(syn.astype(np.int32)), lam, 70)
        dev = np.zeros_like(out)
        np.put_along_axis(dev, order, corr.numpy().astype(np.uint8), 1)
        assert np.array_equal(dev[cons], out[cons])


def test_host_osd_validation_matches_reference():
    H, order, bp, syn = osd_inputs(5, 3, 10, 20, 0.3)
    Hc = native.gf2_pack_cols(H)
    bad = [
        (dict(order=order[:, :-1]), "shape mismatch"),
        (dict(order=np.where(order == 0, 20, order)), "column indices"),
        (dict(m=70), "inconsistent"),
    ]
    for kw, match in bad:
        args = dict(Hcols=Hc, m=10, order=order, bp=bp, syn=syn) | kw
        if "m" in kw:
            args["syn"] = np.zeros((3, kw["m"]), np.uint8)
        for mod in (native, ref_native):
            with pytest.raises(ValueError, match=match):
                mod.gf2_osd0_host(**args)
    for mod in (native, ref_native):
        with pytest.raises(ValueError, match="lam and lam3"):
            mod.gf2_osd_cs_host(Hc, 10, -1, order, bp, syn)


BB144 = pathlib.Path(__file__).parents[1] / "portbench" / "data" / "bb144_r6_p0.003.npz"


@functools.lru_cache(maxsize=None)
def shared_order_inputs(case):
    """A system (sparse), the channel-prior-like column order every lane
    shares, and syndromes: from sparse errors (in span) and, the last
    three, uniform (out of span where the rank is deficient)."""
    rng = np.random.default_rng(len(case))
    if case == "bb144":
        d = np.load(BB144)
        H = sp.csr_matrix((d["data"], d["indices"], d["indptr"]), shape=tuple(d["shape"]))
        pr = d["priors"]
        order = np.argsort(-np.log((1 - pr) / pr), kind="stable").astype(np.int32)
        x = rng.random((16, H.shape[1])) < 3 * pr
    else:
        m, n = (24, 70) if case == "full_rank" else (40, 90)
        H = random_H(rng, m, n, 0.12)
        if case == "deficient":
            H[20:] = H[:20] ^ H[1:21]  # rank at most 21
        H = sp.csr_matrix(H)
        order = rng.permutation(n).astype(np.int32)
        x = rng.random((12, n)) < 0.1
    syn = syndromes(H, x)
    syn[-3:] = rng.random((3, H.shape[0])) < 0.5
    return H, native.gf2_pack_cols(H.toarray()), order, syn


def syndromes(H, x):
    return ((H @ x.T.astype(np.int64)).T % 2).astype(np.uint8)


@pytest.mark.parametrize("case,lam,lam3", [
    *((c, lam, lam3) for c in ("full_rank", "deficient") for lam in (0, 5, 40) for lam3 in (0, 4)),
    ("bb144", 40, 0), ("bb144", 5, 4)])
def test_osd_cs_prepared_matches_full_elimination(case, lam, lam3):
    """The shared-order OSD-CS (one elimination, replayed per syndrome) is
    bitwise the per-lane OSD-CS given that order on every lane and bp = 0."""
    H, Hc, order, syn = shared_order_inputs(case)
    m, n = H.shape
    state = native.gf2_osd_cs_prepare(Hc, m, order)
    out, cons = native.gf2_osd_cs_prepared_host(state, lam, syn, lam3=lam3)
    lanes = (np.broadcast_to(order, (len(syn), n)), np.zeros((len(syn), n), np.uint8), syn)
    want, wcons = native.gf2_osd_cs_host(Hc, m, lam, *lanes, lam3=lam3)
    assert np.array_equal(out, want) and np.array_equal(cons, wcons)
    if case != "bb144":
        ref, rcons = ref_native.gf2_osd_cs_host(Hc, m, lam, *lanes, lam3=lam3)
        assert np.array_equal(out, ref) and np.array_equal(cons, rcons)
    rank = len(state.prow)
    assert state.npw.shape == (n - rank, (m + 63) // 64)
    assert cons[:-3].all()  # sparse errors: in span
    if case == "deficient":
        assert rank < m and not cons.all()
    if case == "full_rank":
        assert rank == m and cons.all()
    # consistent lanes satisfy their syndrome
    assert np.array_equal(syndromes(H, out[cons]), syn[cons])


def test_osd_cs_prepared_state_is_the_orders_alone():
    """Preparing twice gives equal arrays, and solving leaves them as they
    were: the state holds nothing of a syndrome."""
    H, Hc, order, syn = shared_order_inputs("deficient")
    a = native.gf2_osd_cs_prepare(Hc, H.shape[0], order)
    b = native.gf2_osd_cs_prepare(Hc, H.shape[0], order)
    fields = ("prow", "cand", "cw", "pivcol", "npw", "npcol")
    kept = [getattr(a, f).copy() for f in fields]
    native.gf2_osd_cs_prepared_host(a, 40, syn, lam3=4)
    for f, k in zip(fields, kept):
        assert np.array_equal(getattr(a, f), getattr(b, f)) and np.array_equal(getattr(a, f), k)
    with pytest.raises(ValueError, match="shape mismatch"):
        native.gf2_osd_cs_prepared_host(a, 4, syn[:, :-1])
    with pytest.raises(ValueError, match="lam and lam3"):
        native.gf2_osd_cs_prepared_host(a, -1, syn)


def test_portable_popcount_build_matches(tmp_path):
    """The build a host without the popcount instruction runs (the sweep's
    portable code, as on a non-x86 host) loads and gives the same outputs."""
    so = tmp_path / "portable.so"
    subprocess.run(["g++", *native._FLAGS, "-DLDPC_PORTABLE_POPCOUNT", "-o", str(so),
                    *map(str, native._SRCS)], check=True, capture_output=True, timeout=300)
    portable = native._bind(ctypes.CDLL(str(so)))
    H, order, bp, syn = osd_inputs(21, 6, 24, 70, 0.15)
    Hc = native.gf2_pack_cols(H)
    want = native.gf2_osd_cs_host(Hc, 24, 12, order, bp, syn, lam3=6)
    out, cons = np.empty_like(want[0]), np.empty(6, np.uint8)
    portable.gf2_osd_cs_host(Hc.ctypes.data, 70, 24, 1, 12, 6, order.ctypes.data, bp.ctypes.data,
                             syn.ctypes.data, 6, out.ctypes.data, cons.ctypes.data)
    assert np.array_equal(out, want[0]) and np.array_equal(cons.astype(bool), want[1])
