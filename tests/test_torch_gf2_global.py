"""The OSD eliminations for lanes past a block: plain forms and routing.

A lane whose packed system does not fit one Hopper block of the
elimination kernels (``cuda_gf2.launch_plan(...).panel == 0``) takes the
device-memory body of ``csrc/gf2_elim.cu`` (``gf2_cluster_kernel``),
whose plain versions are the column-by-column forms
``ops/gf2.py::gf2_osd0`` / ``gf2_eliminate``.  Here, on the CPU:

  * those plain forms at such a lane (``parity_check_matrix(2000, 10, 5)``,
    1000 x 2000, 252,000 bytes a lane) are bitwise the JAX package's
    ``gf2_osd0`` / ``gf2_eliminate``;
  * a numpy model of the cluster body (``gf2_cluster_kernel``): panels of
    32 columns, the trips on bit slices with the listed rows replacing
    their slice, M by XOR reductions, every row's code in terms of the
    panel's pivot rows at its start, and the pass over the later words
    through eight 16-entry XOR tables a word, is bitwise the plain forms;
  * :func:`cuda_gf2.route` picks the body exactly where ``launch_plan``
    finds no panel;
  * BP+OSD-0, OSD-2 and OSD-CS at that size construct and decode equal to
    the reference.

The kernel itself runs on the card only (tests/test_torch_cuda.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.ops import gf2 as ref_gf2
from ldpcdecoders_tpu_torch.ops import cuda_gf2
from ldpcdecoders_tpu_torch.ops import gf2 as port_gf2

torch.set_num_threads(1)

BIG = dict(n=2000, wr=10, wc=5, rng=3)  # m=1000: 252,000 bytes a lane


@pytest.fixture(scope="module")
def H_big():
    return lt.parity_check_matrix(BIG["n"], BIG["wr"], BIG["wc"], rng=BIG["rng"])


def i32(a):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a).astype(np.uint32).view(np.int32)))


def systems(H, B, seed):
    """B column-permuted copies of H, packed ``[B, W, m]``, and the numpy rows."""
    rng = np.random.default_rng(seed)
    m, n = H.shape
    Hs = np.stack([H[:, rng.permutation(n)] for _ in range(B)]).astype(np.uint32)
    Hp = jax.vmap(ref_gf2.pack_bits)(jnp.asarray(Hs))
    return Hs, jnp.transpose(Hp, (0, 2, 1))


def test_plain_forms_past_a_block_match_reference(H_big):
    m, n = H_big.shape
    W = (n + 31) // 32
    assert cuda_gf2.launch_plan(W, m, osd0=True).panel == 0
    assert cuda_gf2.launch_plan(W, m, osd0=False).panel == 0
    B = 3
    Hs, Ht = systems(H_big, B, seed=1)
    rng = np.random.default_rng(2)
    s = (rng.random((B, m)) < 0.5).astype(np.uint32)
    want = jax.vmap(lambda ht, sv: ref_gf2.gf2_eliminate(ht, sv, n))(Ht, jnp.asarray(s))
    got = port_gf2.gf2_eliminate(i32(Ht), i32(s), n)
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(want[0]))
    for a, b in zip(got[1:4], want[1:4]):  # s', pivcol, rank
        assert np.array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))
    bp = (rng.random((B, n)) < 0.05).astype(np.uint32)
    extra = (rng.random((B, n)) < 0.02).astype(np.uint32)
    resid = (np.einsum("bmn,bn->bm", Hs, extra) % 2).astype(np.uint32)
    want0 = np.asarray(jax.vmap(lambda hp, b, r: ref_gf2.gf2_osd0(hp, b, r, n))(
        jnp.transpose(Ht, (0, 2, 1)), jnp.asarray(bp), jnp.asarray(resid)))
    got0 = cuda_gf2.gf2_osd0_cuda(i32(Ht), i32(resid), i32(bp), n)  # CPU: the plain form
    assert np.array_equal(got0.numpy(), want0.astype(np.int32))


U32 = np.uint32


def to_slices(word, chunks):
    """``[m]`` words -> ``[32, chunks]`` bit slices: bit l of slice t, chunk
    c is bit t of row 32 c + l (the cluster body's layout)."""
    bits = np.zeros((chunks * 32, 32), np.uint64)
    bits[: word.shape[0]] = (word[:, None].astype(np.uint64) >> np.arange(32, dtype=np.uint64)) & 1
    return (bits.reshape(chunks, 32, 32) << np.arange(32, dtype=np.uint64)[None, :, None]).sum(
        1).T.astype(U32)


def from_slices(X, m):
    """The transpose of :func:`to_slices`: ``[32, chunks]`` -> ``[m]`` words."""
    bits = (X[:, :, None].astype(np.uint64) >> np.arange(32, dtype=np.uint64)) & 1
    words = (bits << np.arange(32, dtype=np.uint64)[:, None, None]).sum(0)
    return words.reshape(-1)[:m].astype(U32)


def cluster_body_model(Ht, s, n, bp=None):
    """One lane ``[W, m]`` as ``gf2_cluster_kernel`` computes it, step for
    step: per panel q (word q), the leader's trips on the slices X of word
    q (column t brought up to date from the listed rows of the earlier
    trips whose pivot had bit t; the first free row with the bit; the
    listed rows take the syndrome bit and replace slice t; M[t] = e_t ^ XOR
    of M[u] over the earlier trips u listing the pivot row), every row's code
    XOR of M[t] over the trips listing it, K2's word q (the pivot's bit
    alone in a column with a pivot, else the slice), and the pass ``row ^=
    XOR of the starts of the pivot rows in its code`` over the words past q
    through eight 16-entry tables a word.  Returns ``(Ht, s, pivcol)`` or,
    for OSD-0, the correction."""
    osd0 = bp is not None
    W, m = Ht.shape
    Ht = Ht.astype(U32).copy()
    chunks = (m + 31) // 32
    F = to_slices(np.ones(m, U32), chunks)[0].copy()  # free rows
    Y = to_slices(np.asarray(s, U32) & 1, chunks)[0].copy()  # syndrome bits
    piv = np.full(m, n, np.int64)
    rank = 0
    for q in range(W):
        X = to_slices(Ht[q], chunks)
        M = np.zeros(32, U32)
        bmask = [[] for _ in range(32)]  # column u: the trips whose pivot had bit u
        keys = [None] * 32
        found, done, t_end = 0, False, 32
        for t in range(32):
            j = 32 * q + t
            if j >= n or (not osd0 and rank >= m):
                t_end = t
                break
            if osd0 and not (F & Y).any():
                done, t_end = True, t
                break
            for u in bmask[t]:  # column t brought up to date
                X[t] ^= X[u]
            hit = X[t] & F
            nz = np.flatnonzero(hit)
            if nz.size == 0:
                continue
            kc = int(nz[0])
            kl = (int(hit[kc]) & -int(hit[kc])).bit_length() - 1
            col = X[:, kc].copy()  # the pivot's chunk, later columns up to date
            for u in range(t + 1, 32):
                for w in bmask[u]:
                    col[u] ^= X[w, kc]
            v = (col >> U32(kl)) & 1
            mt = 1 << t
            for u in range(t):
                if (found >> u) & 1 and v[u]:
                    mt ^= int(M[u])
            M[t] = mt
            for u in range(t + 1, 32):
                if v[u]:
                    bmask[u].append(t)
            own = np.zeros(chunks, U32)
            own[kc] = U32(1 << kl)
            r = X[t] & ~own
            X[t] = r
            if (int(Y[kc]) >> kl) & 1:
                Y ^= r
            if osd0 and bp[j]:
                Y[kc] ^= U32(1 << kl)
            F[kc] &= ~U32(1 << kl)
            piv[32 * kc + kl] = j
            keys[t] = 32 * kc + kl
            rank += 1
            found |= 1 << t
        for u in range(t_end, 32):  # the columns past the last trip made
            for w in bmask[u]:
                X[u] ^= X[w]
        made = np.array([(found >> t) & 1 for t in range(32)], bool)
        code = from_slices(np.where(made[:, None], X, U32(0)).astype(U32), m)
        codes = np.zeros(m, U32)
        for t in range(32):
            codes ^= np.where((code >> U32(t)) & 1 == 1, M[t], U32(0)).astype(U32)
        if not osd0:
            word = X.copy()
            for t in np.flatnonzero(made):
                word[t] = 0
                word[t, keys[t] // 32] = U32(1 << (keys[t] % 32))
            Ht[q] = from_slices(word, m)
        if found:
            starts = np.zeros((32, W), U32)
            for v_ in np.flatnonzero(made):
                starts[v_] = Ht[:, keys[v_]]
            upd = np.zeros((W, m), U32)
            for g in range(8):
                table = np.zeros((16, W), U32)  # table[e]: XOR of starts 4g + b, b in e
                for e in range(16):
                    for b in range(4):
                        if (e >> b) & 1:
                            table[e] ^= starts[4 * g + b]
                upd ^= table[(codes >> U32(4 * g)) & 15].T
            upd[: q + 1] = 0  # the panel's and earlier words: zero in the pivot rows
            Ht ^= upd
        if done or 32 * (q + 1) >= n or (not osd0 and rank >= m):
            break
    sbits = np.array([(int(Y[i >> 5]) >> (i & 31)) & 1 for i in range(m)], np.int64)
    if not osd0:
        return Ht, sbits, piv
    corr = np.asarray(bp).astype(np.int64).copy()
    corr[piv[piv < n]] = sbits[piv < n]
    return corr


@pytest.mark.parametrize("osd0", [False, True])
def test_cluster_body_model_matches_plain_forms(H_big, osd0):
    """The cluster body's panels (slices, codes through M, nibble tables)
    give the plain forms' bits: at a small lane, at lanes with more rows
    than columns and with dependent columns, and at the lane past a block."""
    rng = np.random.default_rng(8)
    for H, B, seed in ((lt.parity_check_matrix(120, 6, 3, rng=5), 2, 4),
                       ((rng.random((70, 50)) < 0.3).astype(np.int64), 2, 3),
                       ((rng.random((40, 100)) < 0.2).astype(np.int64), 2, 2), (H_big, 1, 6)):
        m, n = H.shape
        Hs, Ht = systems(H, B, seed)
        Ht = np.asarray(Ht)
        rng_s = np.random.default_rng(seed)
        s = (rng_s.random((B, m)) < 0.5).astype(np.uint32)
        bp = (rng_s.random((B, n)) < 0.05).astype(np.uint32)
        if osd0:
            want = port_gf2.gf2_osd0(i32(Ht), i32(s), i32(bp), n).numpy()
            for b in range(B):
                assert np.array_equal(cluster_body_model(Ht[b], s[b], n, bp[b]), want[b])
        else:
            Ht2, s2, piv, _ = port_gf2.gf2_eliminate(i32(Ht), i32(s), n)
            for b in range(B):
                Hm, sm, pm = cluster_body_model(Ht[b], s[b], n)
                assert np.array_equal(Hm, Ht2[b].numpy().view(np.uint32))
                assert np.array_equal(sm, s2[b].numpy())
                assert np.array_equal(pm, piv[b].numpy())


@pytest.mark.parametrize("W,m", [(32, 900), (75, 1200), (989, 864), (63, 1000), (4, 100),
                                 (40, 1500), (200, 300)])
def test_route_takes_the_device_memory_body_where_no_panel_fits(W, m):
    for osd0 in (False, True):
        plan = cuda_gf2.launch_plan(W, m, osd0=osd0)
        assert cuda_gf2.route(W, m, osd0=osd0) == ("global" if plan.panel == 0 else "shared")
    assert cuda_gf2.global_smem_bytes(m) <= cuda_gf2.MAX_SMEM_BYTES
    # lanes past a block: the (2400, 6, 3) code and the bb144 R=6 DEM
    assert cuda_gf2.route(75, 1200, osd0=False) == "global"
    assert cuda_gf2.route(989, 864, osd0=True) == "global"
    assert cuda_gf2.route(32, 900, osd0=True) == "shared"


def test_workspace_lanes_follow_the_budget():
    from ldpcdecoders_tpu_torch.utils.hbm import gf2_workspace_lanes

    lane = 4 * 989 * 864
    assert gf2_workspace_lanes(989, 864, hbm_bytes=80 * 10**9) == int(20e9 // lane)
    assert gf2_workspace_lanes(989, 864, hbm_bytes=lane) == 1  # at least one lane


@pytest.mark.parametrize("kw", [dict(), dict(osd_order=2),
                                dict(osd_method="combination_sweep", osd_order=8)],
                         ids=["osd0", "osd2", "osd_cs"])
def test_device_osd_past_a_block_matches_reference(H_big, kw):
    """The device OSD no longer refuses a lane past a block: it constructs
    and decodes equal to the reference (OSD-0 bitwise; OSD-2 and OSD-CS
    bitwise here, where BP's reliabilities have no ties)."""
    rng = np.random.default_rng(4)
    syns = (((rng.random((5, H_big.shape[1])) < 0.07) @ H_big.T) % 2).astype(np.uint8)
    port = pt.BeliefPropagationOSDDecoder(H_big, 0.03, 10, device="cpu", **kw)
    ref = lt.BeliefPropagationOSDDecoder(H_big, 0.03, 10, **kw)
    g_ref, c_ref = ref.batch_decode(syns)
    g, c = port.batch_decode(syns)
    assert np.array_equal(c, c_ref) and not c.all()
    assert np.array_equal(g, np.asarray(g_ref))
    assert ((g.astype(np.int64) @ H_big.T) % 2 == syns).all()
