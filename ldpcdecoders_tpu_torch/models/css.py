"""CSS code pair decoding: X and Z syndrome blocks together.

Counterpart of ``ldpcdecoders_tpu/models/css.py``: one module holding a
decoder per stabilizer block, built through :class:`~..config.DecoderConfig`
as the reference builds them, decoding both syndrome batches in one call,
with heralded qubit loss through ``erasures=``.

X-type stabilizers (Hx) detect Z errors and vice versa; the returned
estimates follow that convention: ``z_errors`` reproduce the Hx
syndromes, ``x_errors`` the Hz syndromes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DecoderConfig

__all__ = ["CSSDecoder"]

_VALIDATE_MAX_OPS = 200_000_000  # dense CSS-condition check budget


class CSSDecoder(torch.nn.Module):
    """Paired decoders for a CSS code's (Hx, Hz) stabilizer blocks.

    Args:
      Hx: ``[mx, n]`` X-stabilizer parity checks (detect Z errors).
      Hz: ``[mz, n]`` Z-stabilizer parity checks (detect X errors).
      per: physical error rate (scalar, or per-qubit [n] for decoder
        kinds that support vector priors — validated at construction).
      max_iters: maximum iterations for each block decoder.
      decoder: decoder kind ("bposd" default — syndrome-consistent
        output — or any `DecoderConfig` kind).
      validate_css: check ``Hx @ Hz^T == 0 (mod 2)`` at construction.
        Defaults to True for small codes; skipped automatically (with
        this flag left None) when the dense check would exceed ~2e8
        operations — pass True to force it regardless.
      device: where both blocks decode; None is the current CUDA card.
      **knobs: extra DecoderConfig fields (osd_order, T, C, alpha, ...).
    """

    def __init__(
        self,
        Hx,
        Hz,
        per,
        max_iters: int,
        *,
        decoder: str = "bposd",
        validate_css: bool | None = None,
        device=None,
        **knobs,
    ):
        super().__init__()
        # convert each block independently so a mixed call (one block
        # scipy.sparse, the other a plain list) still works
        if not hasattr(Hx, "tocsr"):
            Hx = np.asarray(Hx)
        if not hasattr(Hz, "tocsr"):
            Hz = np.asarray(Hz)
        sparse_in = hasattr(Hx, "tocsr") or hasattr(Hz, "tocsr")
        if Hx.shape[1] != Hz.shape[1]:
            raise ValueError(
                f"Hx and Hz must act on the same qubits: {Hx.shape[1]} != {Hz.shape[1]}"
            )
        ops = Hx.shape[0] * Hz.shape[0] * Hx.shape[1]
        if validate_css is None:
            validate_css = ops <= _VALIDATE_MAX_OPS or sparse_in
        if validate_css:
            if sparse_in:
                import scipy.sparse as sp

                prod = (sp.csr_matrix(Hx).astype(np.int64)
                        @ sp.csr_matrix(Hz).astype(np.int64).T)
                violated = bool((prod.data % 2 != 0).any())
            else:
                prod = (Hx.astype(np.uint8) @ Hz.astype(np.uint8).T) & 1
                violated = bool(prod.any())
            if violated:
                raise ValueError("CSS condition violated: Hx @ Hz^T != 0 (mod 2)")

        self.n = int(Hx.shape[1])
        self._Hx, self._Hz = Hx, Hz  # kept for logical-failure accounting
        self._vector_prior = bool(np.ndim(per))
        scalar_per = float(np.mean(per)) if self._vector_prior else float(per)
        cfg = DecoderConfig(kind=decoder, per=scalar_per, max_iters=max_iters, **knobs)
        self._cfg = cfg
        self.x_block = cfg.build(Hx, device=device)  # syndromes of Hx -> Z errors
        self.z_block = cfg.build(Hz, device=device)  # syndromes of Hz -> X errors
        self.device = self.x_block.device
        self._per = per
        if self._vector_prior and not (
            self.x_block.supports_per_override and self.x_block.supports_vector_prior
        ):
            raise ValueError(
                f"decoder kind '{decoder}' cannot honor a per-qubit prior "
                "vector; use a scalar per or a prior-capable kind "
                "(bp, bposd, minsum, bpots)"
            )

    def batch_decode(self, syndromes_x, syndromes_z, *, seed: int = 0, per=None,
                     erasures=None):
        """Decode both blocks.

        Args:
          syndromes_x: ``[B, mx]`` syndromes of the X stabilizers.
          syndromes_z: ``[B, mz]`` syndromes of the Z stabilizers.
          per: optional channel-prior override forwarded to both block
            decoders (one decoder pair serves every noise point of a
            sweep).
          erasures: optional ``[B, n]`` bool mask of *lost* qubits
            (heralded loss — photonic / neutral-atom hardware).  A lost
            qubit's X and Z error components are both unknown, so both
            block decoders see prior 0.5 (LLR 0) at erased positions and
            the Pauli prior elsewhere.  Requires a prior-capable decoder
            kind; composes with ``per``.

        Returns ``(z_errors, x_errors, z_converged, x_converged)`` where
        ``z_errors [B, n]`` reproduce ``syndromes_x`` and ``x_errors``
        reproduce ``syndromes_z``.
        """
        syndromes_x = np.asarray(syndromes_x)
        syndromes_z = np.asarray(syndromes_z)
        if syndromes_x.shape[0] != syndromes_z.shape[0]:
            raise ValueError(
                f"X and Z syndrome batches must pair up per shot: "
                f"{syndromes_x.shape[0]} != {syndromes_z.shape[0]}"
            )
        prior = per if per is not None else (self._per if self._vector_prior else None)
        if erasures is not None:
            erasures = np.asarray(erasures).astype(bool)
            B = syndromes_x.shape[0]
            if erasures.shape != (B, self.n):
                raise ValueError(
                    f"expected erasures of shape [B={B}, {self.n}], "
                    f"got {erasures.shape}"
                )
            if not (self.x_block.supports_per_override
                    and self.x_block.supports_vector_prior):
                raise ValueError(
                    f"decoder kind '{self._cfg.kind}' cannot honor erasure "
                    "priors; use a prior-capable kind (bp, bposd, minsum, bpots)"
                )
            base = prior if prior is not None else self._cfg.per
            prior = np.where(erasures, 0.5,
                             np.broadcast_to(np.asarray(base, np.float64),
                                             (B, self.n)))

        def run(block, syn, s):
            if prior is not None:
                return block.batch_decode(syn, seed=s, per=prior)
            return block.batch_decode(syn, seed=s)

        z_err, z_conv = run(self.x_block, syndromes_x, seed)
        x_err, x_conv = run(self.z_block, syndromes_z, seed + 1)
        return z_err, x_err, z_conv, x_conv

    def decode(self, syndrome_x, syndrome_z, *, seed: int = 0):
        """Single-pair convenience; returns ``(z_error, x_error, ok_z, ok_x)``."""
        ze, xe, zc, xc = self.batch_decode(
            np.asarray(syndrome_x)[None], np.asarray(syndrome_z)[None], seed=seed
        )
        return ze[0], xe[0], bool(zc[0]), bool(xc[0])

    def logical_failures(self, z_true, z_hat, x_true, x_hat):
        """Degeneracy-aware logical failure masks for decoded batches.

        A lane fails logically when its residual (true XOR estimate) is
        not a stabilizer: Z residuals must lie in rowspan(Hz), X
        residuals in rowspan(Hx) — exact-recovery comparison over-counts
        failures on degenerate codes (see utils.metrics.logical_failure_rate).

        Returns ``(z_logical_fail [B] bool, x_logical_fail [B] bool)``.
        """
        from ..utils.metrics import gf2_rowspan_reducer

        if not hasattr(self, "_z_span"):
            self._z_span = gf2_rowspan_reducer(self._Hz)
            self._x_span = gf2_rowspan_reducer(self._Hx)
        rz = np.asarray(z_true).astype(np.uint8) ^ np.asarray(z_hat).astype(np.uint8)
        rx = np.asarray(x_true).astype(np.uint8) ^ np.asarray(x_hat).astype(np.uint8)
        return ~self._z_span(rz), ~self._x_span(rx)
