"""Port parity: the native (C++) host tier.

``ldpcdecoders_tpu_torch.native`` builds its own copy of the reference's
C++ sources with g++ (into the package's ``_kernels/``) and binds the same
entry points.  Every entry point is held bitwise against
``ldpcdecoders_tpu.native`` on the same seeded inputs, and the host OSD-0 /
OSD-CS also against the port's own batched plain OSD (ops/gf2.py) on the
same column order, which is how the host route of the decoders stands in
for the elimination kernels.
"""

import numpy as np
import pytest
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
    for src in native._SRCS:  # the reference's C++, comments aside
        ref_src = ref_native._SRCS[[p.endswith(src.name) for p in ref_native._SRCS].index(True)]
        assert code_of(src.read_text()) == code_of(open(ref_src).read())


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
