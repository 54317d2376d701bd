"""Hand-written CUDA kernel for the whole decode of a group-circulant code.

Counterpart of ``ldpcdecoders_tpu/ops/pallas_qc.py``'s fused kernel.  The
kernel lives in ``csrc/qc_minsum.cu`` (built by ``_build.py``):
:func:`qc_minsum_cuda` runs every sweep, the syndrome check, the per-lane
freeze and the early exit of a decode in one launch, with the messages in
shared memory throughout.  For tensors on the CPU it runs the plain torch
version (ops/qc_minsum.py ``qc_minsum_ref``); for CUDA tensors it launches
the kernel or raises.  ``qc_minsum_cuda.launches`` counts the launches, and
``qc_minsum_cuda.routes`` counts them by the kernel's body: ``"layered"``,
``"flooding_two_min"`` and ``"flooding_messages"`` (ops/qc_minsum.py
:func:`qc_flooding_state`).
"""

from __future__ import annotations

import torch

from .cuda_minsum import _check
from .qc_minsum import QCTerms, qc_flooding_state, qc_launch_shape, qc_minsum_ref, qc_modes

__all__ = ["qc_minsum_cuda"]


def qc_minsum_cuda(syndromes, terms: QCTerms, table, L0: float, max_iters: int, *,
                   alpha: float = 1.0, beta: float = 0.0, schedule: str = "flooding",
                   algorithm: str = "minsum", dtype=torch.float32, priors=None):
    """Decode ``syndromes [B, mb*Z]``; returns ``(err int8 [B, nb*Z],
    converged bool [B], iters int32 [B], llrs float32 [B, nb*Z])``.

    Args:
      syndromes: tensor of any real type, nonzero = violated check.
      terms: the code (ops/qc_minsum.py :class:`QCTerms`).
      table: ``terms.table()`` as an int32 tensor on the syndromes' device
        (unused on the CPU).
      L0: scalar channel LLR, used where ``priors`` is None.
      max_iters: most sweeps of one lane.
      alpha, beta: min-sum normalization and offset (ignored by
        sum-product).
      schedule: ``"flooding"`` or ``"layered"`` (serial-C over base rows).
      algorithm: ``"minsum"`` or ``"sumproduct"``.
      dtype: message storage type, float32 or bfloat16; arithmetic and the
        LLR output are float32.
      priors: None, or float32 channel LLRs ``[nb*Z]`` (all lanes) or
        ``[B, nb*Z]`` (per lane).

    Raises ``ValueError`` when one lane's messages do not fit a block's
    shared memory.
    """
    layered, sumprod = qc_modes(schedule, algorithm, dtype)
    device = syndromes.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"expected a CPU or CUDA tensor, got {device}")
    m, n = terms.mb * terms.Z, terms.nb * terms.Z
    if syndromes.ndim != 2 or syndromes.shape[1] != m:
        raise ValueError(f"syndromes must be [B, {m}], got {tuple(syndromes.shape)}")
    B = syndromes.shape[0]
    if priors is not None:
        if priors.dtype != torch.float32:
            raise TypeError(f"priors must be torch.float32, got {priors.dtype}")
        if tuple(priors.shape) not in ((n,), (B, n)):
            raise ValueError(f"priors must be [{n}] or [{B}, {n}], got {tuple(priors.shape)}")
        if priors.device != device:
            raise ValueError(f"priors is on {priors.device}, expected {device}")
    if device.type == "cpu":
        return qc_minsum_ref(syndromes, terms, L0, max_iters, alpha=alpha, beta=beta,
                             schedule=schedule, algorithm=algorithm, dtype=dtype, priors=priors)

    threads, smem = qc_launch_shape(terms, 4 if dtype == torch.float32 else 2, layered, sumprod,
                                    prior=priors is not None)
    _check("table", table, (4 * terms.Eb + terms.mb + terms.nb + 2,), torch.int32, device)
    syn = syndromes if syndromes.dtype == torch.bool else syndromes != 0
    syn = syn.contiguous()
    if priors is not None:
        priors = priors.contiguous()
    err = torch.empty((B, n), dtype=torch.int8, device=device)
    llrs = torch.empty((B, n), dtype=torch.float32, device=device)
    conv = torch.empty((B,), dtype=torch.bool, device=device)
    iters = torch.empty((B,), dtype=torch.int32, device=device)
    if B == 0:
        return err, conv, iters, llrs

    from .._build import load_library

    lib = load_library()  # built and loaded once per process
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):  # the launch goes to the current device
        rc = lib.ldpc_qc_minsum(
            syn.data_ptr(), None if priors is None else priors.data_ptr(), table.data_ptr(),
            err.data_ptr(), llrs.data_ptr(), conv.data_ptr(), iters.data_ptr(),
            B, terms.l, terms.m, terms.mb, terms.nb, terms.Eb, terms.max_row_weight,
            terms.buffered_row_weight, int(max_iters), threads, int(layered), int(sumprod),
            int(dtype == torch.bfloat16), float(alpha), float(beta), float(L0),
            0 if priors is None or priors.ndim == 1 else n, smem, stream)
    if rc != 0:
        raise RuntimeError(f"qc_minsum launch failed: {lib.ldpc_cuda_error_string(rc).decode()}")
    qc_minsum_cuda.launches += 1
    body = "layered" if layered else f"flooding_{qc_flooding_state(terms, sumprod)}"
    qc_minsum_cuda.routes[body] += 1
    return err, conv, iters, llrs


qc_minsum_cuda.launches = 0
qc_minsum_cuda.routes = {"layered": 0, "flooding_two_min": 0, "flooding_messages": 0}
