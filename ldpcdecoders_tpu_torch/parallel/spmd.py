"""SPMD decoding over a process mesh: data-parallel and check-sharded paths.

Counterpart of ``ldpcdecoders_tpu/parallel/spmd.py`` on
``torch.distributed``, one rank per device.  Every function takes the whole
batch on every rank, decodes the rank's slice of it and gathers the outputs
over the ``data`` axis, so that every rank returns the whole batch as numpy
arrays, as the reference returns host arrays.

  * :func:`sharded_batch_decode`, :func:`decode_with_stats`,
    :func:`sharded_mixed_decode` and :func:`make_qc_sharded_decode_fn` split
    the batch: each rank runs the decoder's own decode (its kernels on a
    card) on its slice.  Lanes decode independently, so the outputs are
    bitwise the unsharded decoder's (the reference's global early stop only
    lets finished lanes idle: their outputs are frozen).  A randomized
    decoder (bit-flip) draws its tie-breaks per slice.
  * :func:`make_check_sharded_minsum_fn` and
    :func:`make_check_sharded_sumproduct_fn` are the tensor-parallel form
    for large codes: the check axis is sharded over the ``model`` axis, and
    each iteration sums the ``[B, n]`` partial variable sums with one
    ``all_reduce(SUM)`` over the model group.  The min-sum form runs the
    check update as K3's check-layout iteration (``minsum_check_iter_cuda``)
    and the partial sums as K4 (``minsum_var_cuda``, a zero prior); the
    sum-product form is plain torch, as the reference's is plain jnp.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..codes.graph import TannerGraph
from ..ops.clamps import MSG_CLAMP, TANH_CLAMP
from ..ops.cuda_minsum import minsum_check_iter_cuda, minsum_var_cuda
from ..ops.exclusive import exclusive_prods
from ..ops.minsum import slot_degrees, var_update_ref
from .mesh import axis_index, axis_size, batch_sharding, comm_device, mesh_device

__all__ = [
    "sharded_batch_decode",
    "decode_with_stats",
    "sharded_mixed_decode",
    "make_check_sharded_minsum_fn",
    "make_check_sharded_sumproduct_fn",
    "make_qc_sharded_decode_fn",
]


def _all_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` summed over the ranks of this rank's line along ``axis``
    (``t`` itself on a line of one rank)."""
    if axis_size(mesh, axis) == 1:
        return t
    group = mesh.get_group(axis)
    buf = t.to(comm_device(group))
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def _int32_columns(t: torch.Tensor) -> torch.Tensor:
    """``t [b, ...]`` as int32 columns ``[b, k]`` holding its bits."""
    t = t.reshape(t.shape[0], -1).contiguous()
    if t.dtype in (torch.float32, torch.float64, torch.int64):
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to(torch.int32)
    return t.to(torch.int32)


def _from_columns(cols: torch.Tensor, like: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`_int32_columns` for rows shaped like ``like``'s."""
    cols = cols.contiguous()
    if like.dtype in (torch.float32, torch.float64, torch.int64):
        out = cols.view(like.dtype)
    elif like.dtype == torch.bfloat16:
        out = cols.to(torch.int16).view(torch.bfloat16).float()
    else:
        out = cols.to(like.dtype)
    return out.reshape(cols.shape[0], *like.shape[1:]).numpy()


def _host(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _gather_batch(tensors, mesh, data_axis: str) -> list[np.ndarray]:
    """Each tensor's rows concatenated over the ``data_axis`` ranks in rank
    order, as numpy arrays: one ``all_gather`` of int32 columns holding
    every tensor's bits."""
    parts = axis_size(mesh, data_axis)
    if parts == 1:
        return [_host(t) for t in tensors]
    group = mesh.get_group(data_axis)
    dev = comm_device(group)
    cols = [_int32_columns(t) for t in tensors]
    widths = [c.shape[1] for c in cols]
    local = torch.cat(cols, dim=1).to(dev)
    bufs = [torch.empty_like(local) for _ in range(parts)]
    dist.all_gather(bufs, local, group=group)
    whole = torch.cat(bufs).cpu()
    out, lo = [], 0
    for t, w in zip(tensors, widths):
        out.append(_from_columns(whole[:, lo:lo + w], t))
        lo += w
    return out


def _local_rows(mesh, data_axis: str, batch: int) -> slice:
    return batch_sharding(mesh, 2, data_axis).bounds(batch)


def sharded_batch_decode(decoder, syndromes, mesh, *, data_axis: str = "data", seed: int = 0):
    """Data-parallel batch decode: each rank decodes its slice of the batch
    with ``decoder._decode_batch`` on the decoder's device.  Returns
    ``(errors [B, n] int8, converged [B] bool)`` as numpy on every rank."""
    errors, converged, _ = _decode_slice(decoder, syndromes, mesh, data_axis, seed)
    return errors, converged


def _decode_slice(decoder, syndromes, mesh, data_axis, seed):
    syndromes = np.asarray(syndromes)
    if syndromes.ndim != 2 or syndromes.shape[1] != decoder.m:
        raise ValueError(
            f"expected syndromes of shape [B, {decoder.m}], got {syndromes.shape}")
    rows = _local_rows(mesh, data_axis, syndromes.shape[0])
    local = torch.as_tensor(syndromes[rows], device=decoder.device)
    errors, converged, iters, _ = decoder._decode_batch(local, seed)
    return _gather_batch([errors, converged, iters], mesh, data_axis)


def decode_with_stats(decoder, syndromes, mesh, *, data_axis: str = "data", seed: int = 0):
    """Sharded decode and the global convergence statistics.

    Returns ``(errors, converged, stats)`` where ``stats`` has the whole
    batch's ``converged_fraction``, ``mean_iters``, ``max_iters_used`` and
    ``batch_size``.  They are read from the gathered outputs, which every
    rank holds: the gather is the one collective.
    """
    errors, converged, iters = _decode_slice(decoder, syndromes, mesh, data_axis, seed)
    stats = {
        "converged_fraction": float(np.mean(converged.astype(np.float32))),
        "mean_iters": float(np.mean(iters.astype(np.float32))),
        "max_iters_used": int(iters.max()) if iters.size else 0,
        "batch_size": int(converged.shape[0]),
    }
    return errors, converged, stats


def sharded_mixed_decode(decoder, syndromes, erasures, mesh, *, data_axis: str = "data",
                         per=None):
    """Data-parallel mixed-channel decode: the syndromes, erasure masks and
    per-lane priors of :class:`~..models.mixed.MixedChannelDecoder` split
    over the same batch axis; each rank runs the decoder's peel -> gated BP
    (-> OSD) decode on its slice.  Returns ``(errors, ok)`` as numpy."""
    syndromes = np.asarray(syndromes)
    erasures = np.asarray(erasures).astype(bool)
    B = syndromes.shape[0]
    if erasures.shape != (B, decoder.n):
        raise ValueError(
            f"expected erasures of shape [B={B}, {decoder.n}], got {erasures.shape}")
    rows = _local_rows(mesh, data_axis, B)
    prior = decoder._native_prior(erasures, per)
    dev = decoder.device
    err, ok, _, _ = decoder.mixed(torch.as_tensor(syndromes[rows], device=dev),
                                  torch.as_tensor(erasures[rows], device=dev),
                                  torch.as_tensor(prior[rows], device=dev))
    err, ok = _gather_batch([err, ok], mesh, data_axis)
    return err, ok


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _minsum_rule(alpha: float, dtype):
    """The min-sum check update of a shard, in place on ``mu``: K3's
    check-layout iteration with offset 0 (the reference's rule,
    ``max(alpha * excl, 0)`` with the syndrome's sign)."""
    alpha = float(torch.tensor(alpha, dtype=dtype))

    def rule(mu, total, t):
        minsum_check_iter_cuda(mu, total, t["chk_varidx"], t["syn_flip"], t["chk_mask"],
                               alpha, 0.0, chk_deg=t["chk_deg"])

    def partial(mu_flat, t):
        return minsum_var_cuda(mu_flat, t["v2c"], t["var_mask"], t["zero"], want_nu=False,
                               var_deg=t["var_deg"])[1]

    return rule, partial


def _sumproduct_rule(dtype):
    """The exact sum-product (tanh) check update of a shard, plain torch:
    the clamped leave-one-out tanh product, then ``2 atanh``."""
    max_tanh, max_msg = float(TANH_CLAMP), float(MSG_CLAMP)

    def rule(mu, total, t):
        B, dc, m_loc = mu.shape
        nu = total.index_select(1, t["chk_varidx"]).reshape(B, dc, m_loc) - mu
        th = torch.clamp(torch.tanh(0.5 * nu), -max_tanh, max_tanh)
        th = torch.where(t["chk_mask"], th, torch.ones((), dtype=dtype, device=mu.device))
        # the exact leave-one-out product (tanh is exactly 0 at nu == 0, so a
        # division by the own factor would lose the sign there)
        fwd, bwd = exclusive_prods(th, dim=1)
        excl = torch.clamp(fwd * bwd, -max_tanh, max_tanh)
        msg = torch.clamp(2.0 * torch.atanh(excl), -max_msg, max_msg)
        mu.copy_(t["syn_sign"][:, None, :] * msg)

    def partial(mu_flat, t):
        return var_update_ref(mu_flat, t["v2c"], t["var_mask"], t["zero"], want_nu=False)[1]

    return rule, partial


def _shard_tables(graph: TannerGraph, D: int, d: int):
    """Shard ``d`` of ``D``'s check tables in the slot-major layout of the
    min-sum kernels: ``(m_loc, chk_varidx [dc*m_loc], chk_mask [dc, m_loc],
    v2c [dv*n], var_mask [dv, n])``.  The checks are padded to a multiple of
    ``D`` (a padded check has no edge, so it is inert); a variable's slots
    on this shard come first in its column of the local var-major table,
    which indexes this shard's ``[dc, m_loc]`` messages."""
    m, n, dc, dv = graph.m, graph.n, graph.max_dc, graph.max_dv
    m_pad = _round_up(m, D)
    m_loc = m_pad // D
    chk_vars = np.zeros((m_pad, dc), np.int32)
    chk_vars[:m] = graph.chk_vars
    chk_mask = np.zeros((m_pad, dc), bool)
    chk_mask[:m] = graph.chk_mask
    lo = d * m_loc
    chk_varidx = np.ascontiguousarray(chk_vars[lo:lo + m_loc].T).reshape(-1)
    chk_mask_t = np.ascontiguousarray(chk_mask[lo:lo + m_loc].T)

    flat = graph.v2c_gather.astype(np.int64)  # [n, dv] into the check-major [m * dc]
    sel = graph.var_mask & ((flat // dc) // m_loc == d)
    rank = np.cumsum(sel, axis=1) - 1
    rows, cols = np.nonzero(sel)
    local = flat[rows, cols] - lo * dc  # check-major within the shard
    v2c = np.zeros((dv, n), np.int32)
    var_mask = np.zeros((dv, n), bool)
    v2c[rank[rows, cols], rows] = (local % dc) * m_loc + local // dc
    var_mask[rank[rows, cols], rows] = True
    return m_loc, chk_varidx, chk_mask_t, v2c.reshape(-1), var_mask


def _make_check_sharded_fn(graph, per, max_iters, mesh, rules, *, data_axis, model_axis,
                           dtype):
    names = mesh.mesh_dim_names or ()
    if model_axis not in names:
        raise ValueError(f"the mesh has no '{model_axis}' axis (axes {names})")
    D, d = axis_size(mesh, model_axis), axis_index(mesh, model_axis)
    dev = mesh_device(mesh)
    m, n = graph.m, graph.n
    m_loc, chk_varidx, chk_mask, v2c, var_mask = _shard_tables(graph, D, d)
    lo = d * m_loc
    rule, partial = rules
    L0 = float(torch.tensor(float(np.log((1.0 - per) / per)), dtype=dtype))
    as_dev = dict(device=dev)
    tables = {
        "chk_varidx": torch.as_tensor(chk_varidx.astype(np.int32), **as_dev),
        "chk_mask": torch.as_tensor(chk_mask, **as_dev),
        "v2c": torch.as_tensor(v2c, **as_dev),
        "var_mask": torch.as_tensor(var_mask, **as_dev),
    }
    tables["chk_deg"] = slot_degrees(tables["chk_mask"])
    tables["var_deg"] = slot_degrees(tables["var_mask"])
    chk_vars_loc = tables["chk_varidx"].long()
    dc = graph.max_dc

    def decode(syndromes):
        """``syndromes [B, m]`` -> ``(err [B, n] int8, converged [B] bool,
        iters [B] int32)`` as numpy on every rank."""
        syndromes = torch.as_tensor(np.asarray(syndromes))
        if syndromes.ndim != 2 or syndromes.shape[1] != m:
            raise ValueError(f"expected syndromes of shape [B, {m}], got "
                             f"{tuple(syndromes.shape)}")
        B_all = syndromes.shape[0]
        rows = _local_rows(mesh, data_axis, B_all)
        syn = torch.zeros((rows.stop - rows.start, m_loc), dtype=torch.int32, **as_dev)
        hi = min(m, lo + m_loc)
        if hi > lo:
            syn[:, :hi - lo] = syndromes[rows, lo:hi].to(dev, torch.int32)
        B = syn.shape[0]
        t = dict(tables, syn_flip=syn.bool(), syn_sign=(1.0 - 2.0 * syn.to(dtype)),
                 zero=torch.zeros((B, n), dtype=dtype, **as_dev))
        mu = torch.zeros((B, dc, m_loc), dtype=dtype, **as_dev)
        total = torch.full((B, n), L0, dtype=dtype, **as_dev)
        err = torch.zeros((B, n), dtype=torch.int8, **as_dev)
        done = torch.zeros((B,), dtype=torch.bool, **as_dev)
        iters = torch.zeros((B,), dtype=torch.int32, **as_dev)
        it, undone = 0, B_all
        while it < max_iters and undone > 0:
            rule(mu, total, t)
            sum_mu = _all_reduce(partial(mu.reshape(B, dc * m_loc), t), mesh, model_axis)
            total = L0 + sum_mu
            active = ~done
            err = torch.where(active[:, None], (total < 0).to(torch.int8), err)
            # this shard's checks through its own adjacency, O(edges): no
            # dense H, so from_edges graphs shard as well
            err_g = err.to(torch.int32).index_select(1, chk_vars_loc).reshape(B, dc, m_loc)
            syn_hat = (err_g * t["chk_mask"]).sum(dim=1) & 1
            mis = _all_reduce((syn_hat != syn).sum(dim=1), mesh, model_axis)
            ok = mis == 0
            iters = torch.where(ok & active, it + 1, iters)
            done = done | ok
            it += 1
            undone = int(_all_reduce((~done).sum().reshape(1), mesh, data_axis))
        iters = torch.where(done, iters, it).to(torch.int32)
        return tuple(_gather_batch([err, done, iters], mesh, data_axis))

    return decode


def make_check_sharded_minsum_fn(graph: TannerGraph, per: float, max_iters: int, mesh, *,
                                 data_axis: str = "data", model_axis: str = "model",
                                 alpha: float = 1.0, dtype=torch.float32):
    """Min-sum BP with the *check* axis sharded over the ``model`` mesh axis.

    Each model rank owns ``ceil(m / D)`` checks and their check->variable
    messages ``mu [B, dc, m_loc]`` (the check layout's slot order); the
    variables' totals come from one ``all_reduce(SUM)`` of the partial sums
    over the model group per iteration.  The batch is split over ``data``
    as well.  The loop runs while the data group's count of undecided lanes
    is above 0.  Each rank computes on its mesh device
    (:func:`.mesh.mesh_device`).  Returns ``syndromes [B, m] -> (err [B, n]
    int8, converged [B] bool, iters [B] int32)``.

    The syndrome check of each shard gathers through its own check
    adjacency, so graphs compiled from edge lists (``TannerGraph.from_edges``)
    shard without a dense H.
    """
    return _make_check_sharded_fn(graph, per, max_iters, mesh, _minsum_rule(alpha, dtype),
                                  data_axis=data_axis, model_axis=model_axis, dtype=dtype)


def make_check_sharded_sumproduct_fn(graph: TannerGraph, per: float, max_iters: int, mesh, *,
                                     data_axis: str = "data", model_axis: str = "model",
                                     dtype=torch.float32):
    """Exact sum-product BP (LLR-domain tanh rule) with the check axis
    sharded: :func:`make_check_sharded_minsum_fn`'s structure with the
    clamped tanh-product check rule (plain torch).  Also dense-free."""
    return _make_check_sharded_fn(graph, per, max_iters, mesh, _sumproduct_rule(dtype),
                                  data_axis=data_axis, model_axis=model_axis, dtype=dtype)


def make_qc_sharded_decode_fn(decoder, mesh, *, data_axis: str = "data"):
    """Data-parallel wrapper of :class:`~..models.qc_minsum.QCMinSumDecoder`:
    each rank runs the whole-decode call (the QC kernel on a card) on its
    slice, with no collective but the gather.  Returns ``syndromes [B, m]
    -> (err, converged, iters, llrs)`` as numpy; ``B`` must be a multiple of
    the data axis times the decoder's ``batch_tile`` (1 here)."""
    n_dev = axis_size(mesh, data_axis)
    tile = getattr(decoder, "batch_tile", 1)

    def decode(syndromes):
        syndromes = np.asarray(syndromes)
        B = syndromes.shape[0]
        if B % (n_dev * tile):
            raise ValueError(
                f"batch {B} must be a multiple of data-mesh size ({n_dev}) "
                f"x batch_tile ({tile})")
        rows = _local_rows(mesh, data_axis, B)
        err, conv, iters, aux = decoder._decode_batch(
            torch.as_tensor(syndromes[rows], device=decoder.device))
        soft = next(iter(aux.values()))  # "llrs" ("log_probabs": lifted sum-product)
        return tuple(_gather_batch([err, conv, iters, soft], mesh, data_axis))

    return decode
