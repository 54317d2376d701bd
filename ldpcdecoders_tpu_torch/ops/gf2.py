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
as a few batched tensor operations.
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
    "osdw_sweep",
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


def gf2_osd0(Ht: torch.Tensor, resid: torch.Tensor, bp_err: torch.Tensor, n: int):
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
    """
    B, W, m = Ht.shape
    device = Ht.device
    Ht = Ht.to(torch.int32).clone()
    s = resid.to(torch.int32).clone()
    bp = bp_err.to(torch.int32)
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
    return scatter_pivots(bp, piv, s, n)


def scatter_pivots(values: torch.Tensor, piv: torch.Tensor, s: torch.Tensor, n: int):
    """``values`` [B, n] with ``values[b, piv[b, i]] = s[b, i]`` for every row
    whose pivot is a column (the sentinel ``n`` is dropped)."""
    B = values.shape[0]
    out = torch.cat([values.to(torch.int32),
                     torch.zeros((B, 1), dtype=torch.int32, device=values.device)], dim=1)
    out.scatter_(1, piv.to(torch.int64), s.to(torch.int32))
    return out[:, :n]


def gf2_eliminate(Ht: torch.Tensor, s: torch.Tensor, n: int):
    """Batched Gauss–Jordan RREF of packed columns, syndrome co-transformed.

    The pivot of column j is the first unused row with bit j set; it is
    XORed into every other row with that bit.

    Args:
      Ht: ``[B, W, m]`` int32 transposed packed rows.
      s: ``[B, m]`` 0/1 syndromes.
      n: column count.

    Returns ``(Ht [B, W, m] int32, s [B, m] int32, pivcol [B, m] int32, r [B])``
    where ``pivcol[b, i]`` is row i's pivot column (sentinel ``n``) and
    ``r`` the rank.
    """
    B, W, m = Ht.shape
    device = Ht.device
    Ht = Ht.to(torch.int32).clone()
    s = s.to(torch.int32).clone()
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
        r = r + found.to(torch.int32)
    return Ht, s, piv, r


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
