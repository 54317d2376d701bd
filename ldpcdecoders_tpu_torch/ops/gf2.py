"""Bit-packed batched GF(2) elimination for OSD post-processing (plain torch).

Counterpart of ``ldpcdecoders_tpu/ops/gf2.py``.  The reference package
writes single-lane functions and ``vmap``s them; here every function takes
a leading batch axis.  Each lane's reliability-sorted H is bit-packed into
32-bit words and stored transposed, ``Ht [B, W, m]``: word w of row i is
``Ht[b, w, i]`` and holds columns 32w..32w+31 (little-endian in the word).

torch has no usable uint32, so words are ``int32`` tensors whose bit
patterns equal the reference's uint32 words (compare with
``.numpy().view(np.uint32)``).  ``>>`` on int32 is arithmetic; every shift
here is either masked with ``& 1`` afterwards or only its low bits are kept.

These loops are the plain versions of the CUDA kernels in
``ops/cuda_gf2.py`` (which the decoders call); they run every column trip
as a few batched tensor operations.  ``gf2_osd0_blocked`` and
``gf2_eliminate_blocked`` compute the same results by panels of columns,
row codes and an XOR table, the way the kernels do.  ``osdw_sweep`` and
``osd_cs_sweep`` search the completions of an eliminated system (the
reference computes them in jnp, not Pallas; the decoders run them in
torch on the card, on the elimination kernel's output).
"""

from __future__ import annotations

import torch

__all__ = [
    "pack_bits",
    "wrap_int32",
    "column",
    "parity32",
    "scatter_pivots",
    "gf2_osd0",
    "gf2_eliminate",
    "gf2_osd0_blocked",
    "gf2_eliminate_blocked",
    "osdw_sweep",
    "osd_cs_sweep",
    "gf2_osdw",
    "gf2_osd_cs",
]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a 0/1 tensor ``[..., n]`` into int32 words ``[..., ceil(n/32)]``.

    Bit k of word w holds column ``32*w + k``.  The words are summed in
    int64 and wrapped to int32, so bit 31 never overflows.
    """
    n = bits.shape[-1]
    W = (n + 31) // 32
    b = bits.to(torch.int64)
    if W * 32 != n:
        b = torch.nn.functional.pad(b, (0, W * 32 - n))
    b = b.reshape(*bits.shape[:-1], W, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return wrap_int32((b << shifts).sum(dim=-1))


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of a non-negative int64 tensor, as an int32 bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def column(Ht: torch.Tensor, j: int) -> torch.Tensor:
    """0/1 bits of column ``j`` of every lane: ``[B, W, m] -> [B, m]``."""
    return (Ht[:, j >> 5, :] >> (j & 31)) & 1


def parity32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount parity (0/1) of int32 words, by XOR folding."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def _first_row(avail: torch.Tensor):
    """Index of the first True row per lane (``m`` where none) and ``found``."""
    m = avail.shape[1]
    rows = torch.arange(m, device=avail.device)
    k = torch.where(avail, rows, m).amin(dim=1)
    return k, k < m


def _xor_words(W: int, j: int) -> int:
    """Words a row XOR of column ``j``'s trip needs: the packed words from
    the pivot's, ``j // 32``, on, and the syndrome bit.  The words before
    are zero in an unused pivot row: every earlier column either had a
    pivot, whose trip cleared its bit in every other row, or had no unused
    row with its bit set."""
    return W - j // 32 + 1


def gf2_osd0(Ht: torch.Tensor, resid: torch.Tensor, bp_err: torch.Tensor, n: int,
             return_work: bool = False):
    """Batched OSD-0 elimination; returns the ``[B, n]`` int32 correction.

    Semantics of the reference's OSD-0 kernel (pallas_gf2.py ``_osd0_kernel``,
    bit-identical to ops/gf2.py ``gf2_osd0``): a used-row mask instead of
    row swaps and eager elimination of every other row.  Per lane, the
    column loop stops once the residual outside the pivot space is empty;
    ``bp_err[j]`` is folded into the residual with the current column.  The
    correction is ``bp_err`` with each pivot column reassigned from the
    residual.

    Args:
      Ht: ``[B, W, m]`` int32 transposed packed rows (sorted columns).
      resid: ``[B, m]`` 0/1 residual syndrome of ``bp_err``.
      bp_err: ``[B, n]`` 0/1 BP hard decisions (sorted order).
      n: column count.
      return_work: also return the work these inputs needed, ``(trips [B],
        row_xors [B], row_words [B])`` int64: the column trips a lane made
        before it stopped, the rows its pivots were XORed into, and the
        words those XORs need (see :func:`_xor_words`).
    """
    B, W, m = Ht.shape
    device = Ht.device
    Ht = Ht.to(torch.int32).clone()
    s = resid.to(torch.int32).clone()
    bp = bp_err.to(torch.int32)
    trips = torch.zeros(B, dtype=torch.int64, device=device)
    row_xors = torch.zeros(B, dtype=torch.int64, device=device)
    row_words = torch.zeros(B, dtype=torch.int64, device=device)
    piv = torch.full((B, m), n, dtype=torch.int32, device=device)
    rows = torch.arange(m, device=device)
    active = torch.ones(B, dtype=torch.bool, device=device)
    for j in range(n):
        unused = piv == n
        active = active & ((s != 0) & unused).any(dim=1)
        if (j & 31) == 0 and not bool(active.any()):
            break  # every lane has stopped: the remaining trips are no-ops
        col = column(Ht, j)
        k, found = _first_row((col == 1) & unused)
        do = active & found
        s = s ^ (col & (do & (bp[:, j] == 1)).to(torch.int32)[:, None])
        kc = k.clamp(max=m - 1)
        pivrow = Ht.gather(2, kc[:, None, None].expand(B, W, 1))  # [B, W, 1]
        pivs = s.gather(1, kc[:, None])  # [B, 1]
        is_k = rows[None, :] == k[:, None]
        elim = (col == 1) & ~is_k & do[:, None]
        Ht = torch.where(elim[:, None, :], Ht ^ pivrow, Ht)
        s = torch.where(elim, s ^ pivs, s)
        piv = torch.where(is_k & do[:, None], j, piv)
        if return_work:
            trips += active
            row_xors += elim.sum(dim=1)
            row_words += elim.sum(dim=1) * _xor_words(W, j)
    corr = scatter_pivots(bp, piv, s, n)
    return (corr, (trips, row_xors, row_words)) if return_work else corr


def scatter_pivots(values: torch.Tensor, piv: torch.Tensor, s: torch.Tensor, n: int):
    """``values`` [B, n] with ``values[b, piv[b, i]] = s[b, i]`` for every row
    whose pivot is a column (the sentinel ``n`` is dropped)."""
    B = values.shape[0]
    out = torch.cat([values.to(torch.int32),
                     torch.zeros((B, 1), dtype=torch.int32, device=values.device)], dim=1)
    out.scatter_(1, piv.to(torch.int64), s.to(torch.int32))
    return out[:, :n]


def gf2_eliminate(Ht: torch.Tensor, s: torch.Tensor, n: int, return_work: bool = False):
    """Batched Gauss–Jordan RREF of packed columns, syndrome co-transformed.

    The pivot of column j is the first unused row with bit j set; it is
    XORed into every other row with that bit.

    Args:
      Ht: ``[B, W, m]`` int32 transposed packed rows.
      s: ``[B, m]`` 0/1 syndromes.
      n: column count.

    Returns ``(Ht [B, W, m] int32, s [B, m] int32, pivcol [B, m] int32, r [B])``
    where ``pivcol[b, i]`` is row i's pivot column (sentinel ``n``) and
    ``r`` the rank; with ``return_work`` a fifth item ``(trips [B],
    row_xors [B], row_words [B])`` int64, the column trips a lane made
    before it reached full rank, the rows its pivots were XORed into, and
    the words those XORs need (:func:`_xor_words`).
    """
    B, W, m = Ht.shape
    device = Ht.device
    Ht = Ht.to(torch.int32).clone()
    s = s.to(torch.int32).clone()
    trips = torch.zeros(B, dtype=torch.int64, device=device)
    row_xors = torch.zeros(B, dtype=torch.int64, device=device)
    row_words = torch.zeros(B, dtype=torch.int64, device=device)
    piv = torch.full((B, m), n, dtype=torch.int32, device=device)
    rows = torch.arange(m, device=device)
    r = torch.zeros(B, dtype=torch.int32, device=device)
    for j in range(n):
        if (j & 31) == 0 and bool((r == m).all()):
            break  # every lane has full rank: the remaining trips are no-ops
        col = column(Ht, j)
        k, found = _first_row((col == 1) & (piv == n))
        kc = k.clamp(max=m - 1)
        pivrow = Ht.gather(2, kc[:, None, None].expand(B, W, 1))
        pivs = s.gather(1, kc[:, None])
        is_k = rows[None, :] == k[:, None]
        elim = (col == 1) & ~is_k & found[:, None]
        Ht = torch.where(elim[:, None, :], Ht ^ pivrow, Ht)
        s = torch.where(elim, s ^ pivs, s)
        piv = torch.where(is_k & found[:, None], j, piv)
        if return_work:
            trips += r < m
            row_xors += elim.sum(dim=1)
            row_words += elim.sum(dim=1) * _xor_words(W, j)
        r = r + found.to(torch.int32)
    return (Ht, s, piv, r, (trips, row_xors, row_words)) if return_work else (Ht, s, piv, r)


def _eliminate_blocked(Ht, s, n, panel, bp):
    """Elimination by panels of ``panel`` columns, as ``csrc/gf2_elim.cu``
    computes it; ``bp`` is None for the full elimination, else OSD-0's
    ``bp_err`` (with its early stop and residual fold).

    Per panel: (1) the column trips run on the panel's word and the syndrome
    only, and every row records a code, bit t set when the pivot of the
    panel's column t was XORed into it; (2) ``Q_t``, the pivot row as it
    stood when its column was reached, and the table ``T[c]`` = XOR of the
    ``Q_t`` with bit t in c, by doubling; (3) every row XORs ``T[code]``
    into its other words once (OSD-0 skips the words left of the panel:
    no later column reads them).  Returns ``(Ht, s, pivcol, r)``.
    """
    if panel not in (1, 2, 4, 8):  # the table has 2^panel rows
        raise ValueError(f"panel must be 1, 2, 4 or 8, got {panel}")
    osd0 = bp is not None
    B, W, m = Ht.shape
    device = Ht.device
    Ht = Ht.to(torch.int32).clone()
    s = s.to(torch.int32).clone()
    piv = torch.full((B, m), n, dtype=torch.int32, device=device)
    rows = torch.arange(m, device=device)
    words = torch.arange(W, device=device)
    r = torch.zeros(B, dtype=torch.int32, device=device)
    active = torch.ones(B, dtype=torch.bool, device=device)
    for j0 in range(0, n, panel):
        if not bool(active.any() if osd0 else (r < m).any()):
            break  # every lane has stopped: the remaining panels are no-ops
        wd = j0 >> 5
        word = Ht[:, wd, :].clone()  # updated in full by every trip
        code = torch.zeros((B, m), dtype=torch.int64, device=device)
        pivrows = []
        for t in range(min(panel, n - j0)):
            j = j0 + t
            unused = piv == n
            if osd0:
                active = active & ((s != 0) & unused).any(dim=1)
            col = (word >> (j & 31)) & 1
            k, found = _first_row((col == 1) & unused)
            do = found & active
            kc = k.clamp(max=m - 1)
            pivword = word.gather(1, kc[:, None])
            pivs = s.gather(1, kc[:, None])
            is_k = (rows[None, :] == k[:, None]) & do[:, None]
            elim = (col == 1) & ~is_k & do[:, None]
            word = torch.where(elim, word ^ pivword, word)
            s = torch.where(elim, s ^ pivs, s)
            if osd0:  # bp_err[j] stays on the pivot row alone
                s = s ^ (is_k & (bp[:, j] == 1)[:, None]).to(torch.int32)
            code = code | (elim.to(torch.int64) << t)
            piv = torch.where(is_k, j, piv)
            pivrows.append(torch.where(do, k, m))
            r = r + do.to(torch.int32)
        # T[c] for every code over the trips made, by doubling; the pivot
        # row of trip t had the pivots of its code's lower bits XORed in
        T = torch.zeros((B, 1, W), dtype=torch.int32, device=device)
        for t, k in enumerate(pivrows):
            kc = k.clamp(max=m - 1)
            start = Ht.gather(2, kc[:, None, None].expand(B, W, 1))[:, :, 0]  # [B, W]
            low = code.gather(1, kc[:, None])[:, 0] & ((1 << t) - 1)
            q = start ^ T.gather(1, low[:, None, None].expand(B, 1, W))[:, 0]
            q = torch.where((k < m)[:, None], q, 0)
            T = torch.cat([T, T ^ q[:, None, :]], dim=1)
        upd = T.gather(1, code[:, :, None].expand(B, m, W)).transpose(1, 2)  # [B, W, m]
        apply_to = (words > wd) if osd0 else (words != wd)
        Ht = torch.where(apply_to[None, :, None], Ht ^ upd, Ht)
        Ht[:, wd, :] = word
    return Ht, s, piv, r


def gf2_osd0_blocked(Ht: torch.Tensor, resid: torch.Tensor, bp_err: torch.Tensor, n: int,
                     panel: int = 8):
    """:func:`gf2_osd0` computed by panels of ``panel`` columns (1, 2,
    4 or 8) with row codes and an XOR table, step for step as the CUDA
    kernel does; bitwise the same correction."""
    bp = bp_err.to(torch.int32)
    _, s, piv, _ = _eliminate_blocked(Ht, resid, n, panel, bp)
    return scatter_pivots(bp, piv, s, n)


def gf2_eliminate_blocked(Ht: torch.Tensor, s: torch.Tensor, n: int, panel: int = 8):
    """:func:`gf2_eliminate` computed by panels of ``panel`` columns, as the
    CUDA kernel does; bitwise the same ``(Ht, s, pivcol, r)``."""
    return _eliminate_blocked(Ht, s, n, panel, None)


def _first_min(x: torch.Tensor):
    """Per-row minimum and the index of its first occurrence."""
    mn = x.amin(dim=1)
    idx = torch.arange(x.shape[1], device=x.device)
    first = torch.where(x == mn[:, None], idx, x.shape[1]).amin(dim=1)
    return mn, first


def osdw_sweep(Ht, s, pivcol, r, bp_err, osd_order: int, n: int):
    """2^w most-reliable-column sweep over RREF systems (batched).

    Semantics of the reference package's ``osdw_sweep``: candidate x
    assigns the binary digits of x to the first ``osd_order`` most-reliable
    non-pivot columns (x = 0 keeps BP's decisions; bits past the
    information set are masked), completes the pivot columns from the
    transformed syndrome, and the minimum-Hamming-weight completion wins,
    the first candidate on ties.  A candidate's completion differs from the
    base candidate's by an XOR of the swept RREF columns, so all candidate
    weights come from one ``[c, w] @ [w, m]`` product per chunk; float32 is
    exact for these 0/1 sums of at most w terms.

    Args:
      Ht, s, pivcol, r: outputs of :func:`gf2_eliminate`.
      bp_err: ``[B, n]`` 0/1 BP hard decisions (sorted order).
      osd_order: sweep order w (2^w candidates).
      n: column count.

    Returns the ``[B, n]`` int32 0/1 solution in sorted column order.
    """
    B, W, m = Ht.shape
    device = Ht.device
    is_piv = scatter_pivots(torch.zeros((B, n), dtype=torch.int32, device=device),
                            pivcol, torch.ones_like(pivcol), n).bool()
    err0 = bp_err.to(torch.int32)
    # base candidate (x = 0): BP's decisions on every non-pivot column
    err_mr0 = pack_bits(err0) & pack_bits(~is_piv)  # [B, W]
    folded = torch.zeros((B, m), dtype=torch.int32, device=device)
    for w in range(W):
        folded = folded ^ (Ht[:, w, :] & err_mr0[:, w, None])
    base_vals = s.to(torch.int32) ^ parity32(folded)  # [B, m] pivot assignments
    if osd_order == 0:
        return scatter_pivots(err0, pivcol, base_vals, n)

    w = osd_order
    mr_order = torch.argsort(is_piv.to(torch.int8), dim=1, stable=True)
    mr_cols = mr_order[:, :w]  # [B, w] most-reliable non-pivot columns
    b_idx = torch.arange(w, device=device)
    swept = b_idx[None, :] < (n - r)[:, None]  # [B, w]
    words = Ht.gather(1, (mr_cols >> 5)[:, :, None].expand(B, w, m))  # [B, w, m]
    C = (words >> (mr_cols & 31).to(torch.int32)[:, :, None]) & 1
    C = torch.where(swept[:, :, None], C, 0).to(torch.float32)  # [B, w, m]
    base_bits = err0.gather(1, mr_cols)  # [B, w]
    base_np_weight = (err0 * (~is_piv).to(torch.int32)).sum(dim=1)  # [B]
    piv_valid = (pivcol < n).to(torch.int32)

    def swept_bits(x):
        """Values of the swept columns for candidates ``x`` [1 or B, c]: [B, c, w]."""
        patt = ((x[..., None] >> b_idx) & 1).to(torch.int32)
        applied = (x != 0)[..., None] & swept[:, None, :]
        return torch.where(applied, patt, base_bits[:, None, :])

    def flips(newbits):
        delta = (newbits ^ base_bits[:, None, :]).to(torch.float32)
        return (delta @ C).to(torch.int32) & 1  # [B, c, m]

    N = 1 << w
    chunk = min(N, 512)
    best_w = torch.full((B,), n + 1, dtype=torch.int64, device=device)
    best_x = torch.zeros((B,), dtype=torch.int64, device=device)
    for x0 in range(0, N, chunk):
        x = x0 + torch.arange(chunk, device=device)
        newbits = swept_bits(x[None, :])
        piv_w = ((base_vals[:, None, :] ^ flips(newbits)) * piv_valid[:, None, :]).sum(dim=2)
        np_w = base_np_weight[:, None] + (newbits - base_bits[:, None, :]).sum(dim=2)
        wmin, i = _first_min(np_w + piv_w)
        better = wmin < best_w  # strict: earlier candidates win ties
        best_w = torch.where(better, wmin, best_w)
        best_x = torch.where(better, x0 + i, best_x)

    # materialize only the winner
    bits_s = swept_bits(best_x[:, None])  # [B, 1, w]
    flip_s = flips(bits_s)[:, 0, :]  # [B, m]
    bits_s = bits_s[:, 0, :]
    err = err0.scatter(1, mr_cols, bits_s)  # pivot writes below override
    return scatter_pivots(err, pivcol, base_vals ^ flip_s, n)


def osd_cs_sweep(Ht, s, pivcol, r, bp_err, lam: int, n: int):
    """Combination-sweep OSD ("OSD-CS") over RREF systems (batched).

    Semantics of the reference package's ``osd_cs_sweep``: the candidates
    are the base completion (BP's decisions on every non-pivot column),
    every single flip of a non-pivot column, and every pair flip within the
    first ``lam`` most-reliable non-pivot columns (Roffe et al. 2020).
    Flipping non-pivot column c changes the pivot completion by the RREF
    column C_c, so a single flip's weight change is ``(1 - 2 err[c]) +
    t_c`` with ``t_c = sum_i v_i C_c[i]`` (``v_i = +1`` where pivot row i's
    base assignment is 0, -1 where it is 1), and a pair's is the two
    singles' minus twice their ``v``-weighted overlap.  Ties: the base wins
    over singles, singles (most reliable first) over pairs, pairs in
    lexicographic (i, j) order; flips past the information set are masked.

    Args:
      Ht, s, pivcol, r: outputs of :func:`gf2_eliminate`.
      bp_err: ``[B, n]`` 0/1 BP hard decisions (sorted order).
      lam: pair-sweep depth.
      n: column count.

    Returns the ``[B, n]`` int32 0/1 solution in sorted column order.
    """
    B, W, m = Ht.shape
    device = Ht.device
    lam = int(min(lam, n))
    is_piv = scatter_pivots(torch.zeros((B, n), dtype=torch.int32, device=device),
                            pivcol, torch.ones_like(pivcol), n).bool()
    mr_order = torch.argsort(is_piv.to(torch.int8), dim=1, stable=True)  # non-pivots first
    n_mr = (n - r.to(torch.int64))[:, None]  # [B, 1]
    err0 = bp_err.to(torch.int32)
    err_mr0 = pack_bits(err0) & pack_bits(~is_piv)  # [B, W]
    folded = torch.zeros((B, m), dtype=torch.int32, device=device)
    for w in range(W):
        folded = folded ^ (Ht[:, w, :] & err_mr0[:, w, None])
    base_vals = s.to(torch.int32) ^ parity32(folded)  # [B, m] pivot assignments
    v = (1 - 2 * base_vals) * (pivcol < n).to(torch.int32)  # [B, m]

    # t_c for every column, one packed word of 32 columns at a time
    shifts = torch.arange(32, dtype=torch.int32, device=device)
    t = torch.cat([(v[:, :, None] * ((Ht[:, w, :, None] >> shifts) & 1)).sum(dim=1)
                   for w in range(W)], dim=1)[:, :n]  # [B, n]
    big = 1 << 30
    delta1_nat = (1 - 2 * err0) + t.to(torch.int32)  # [B, n] sorted-column order
    delta1 = delta1_nat.gather(1, mr_order)  # enumeration order
    j_idx = torch.arange(n, device=device)
    delta1 = torch.where(j_idx[None, :] < n_mr, delta1, big)
    best1, j1 = _first_min(delta1)

    if lam >= 2:
        mr_lam = mr_order[:, :lam]  # [B, lam]
        words = Ht.gather(1, (mr_lam >> 5)[:, :, None].expand(B, lam, m))  # [B, lam, m]
        Cf = ((words >> (mr_lam & 31).to(torch.int32)[:, :, None]) & 1).to(torch.float32)
        # overlap(i, j) = sum_k v_k C_i[k] C_j[k]: exact in float32, |sums| <= m
        G = ((Cf * v[:, None, :].to(torch.float32)) @ Cf.transpose(1, 2)).to(torch.int32)
        d1l = delta1_nat.gather(1, mr_lam)  # [B, lam]
        pair = d1l[:, :, None] + d1l[:, None, :] - 2 * G  # [B, lam, lam]
        li = torch.arange(lam, device=device)
        valid = (li[:, None] < li[None, :])[None] & (li[None, None, :] < n_mr[:, :, None])
        pair = torch.where(valid, pair, big)
        best2, flat = _first_min(pair.reshape(B, lam * lam))  # row-major: lexicographic
        p_i, p_j = flat // lam, flat % lam
    else:
        best2 = torch.full((B,), big, dtype=torch.int32, device=device)
        p_i = p_j = torch.zeros((B,), dtype=torch.int64, device=device)

    # precedence: base (delta 0), then singles, then pairs; strict wins
    use1 = best1 < 0
    use2 = (best2 < 0) & (best2 < best1)
    col = lambda idx: mr_order.gather(1, idx[:, None])[:, 0]  # noqa: E731
    c1 = torch.where(use2, col(p_i), torch.where(use1, col(j1), n))
    c2 = torch.where(use2, col(p_j), n)

    def bits_of(c):
        cc = c.clamp(max=n - 1)
        word = Ht.gather(1, (cc >> 5)[:, None, None].expand(B, 1, m))[:, 0, :]
        return torch.where((c < n)[:, None], (word >> (cc & 31).to(torch.int32)[:, None]) & 1, 0)

    flip = bits_of(c1) ^ bits_of(c2)  # [B, m] pivot-assignment flips
    err = torch.cat([err0, torch.zeros((B, 1), dtype=torch.int32, device=device)], dim=1)
    for c in (c1, c2):  # the sentinel n lands in the dropped column
        err = err.scatter(1, c[:, None], 1 - err0.gather(1, c.clamp(max=n - 1)[:, None]))
    return scatter_pivots(err[:, :n], pivcol, base_vals ^ flip, n)


def gf2_osdw(Ht, bp_err, s, osd_order: int, n: int):
    """OSD-w: Gauss–Jordan RREF + the 2^w candidate sweep (batched plain
    form of the reference's ``gf2_osdw``, taking the transposed packed rows
    as :func:`gf2_osd_cs` does); ``Ht [B, W, m]`` int32, ``bp_err [B, n]``
    and ``s [B, m]`` 0/1.  Returns the ``[B, n]`` int32 solution."""
    Ht2, s2, piv, r = gf2_eliminate(Ht, s, n)
    return osdw_sweep(Ht2, s2, piv, r, bp_err, osd_order, n)


def gf2_osd_cs(Ht, bp_err, s, lam: int, n: int):
    """OSD-CS: Gauss–Jordan RREF + combination sweep (batched plain form of
    the reference's ``gf2_osd_cs``); ``Ht [B, W, m]`` int32, ``s [B, m]``.
    The decoders run the same sweep on the elimination kernel's output."""
    Ht2, s2, piv, r = gf2_eliminate(Ht, s, n)
    return osd_cs_sweep(Ht2, s2, piv, r, bp_err, lam, n)
