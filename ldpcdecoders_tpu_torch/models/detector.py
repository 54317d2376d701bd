"""Generic detector-graph decoding: circuit-level noise import.

Counterpart of ``ldpcdecoders_tpu/models/detector.py``.  A detector error
model (DEM) extracted from a syndrome circuit lists independent error
mechanisms, each flipping a known set of detectors and logical
observables.  :class:`DetectorGraphDecoder` decodes any such model with
the batched decoders of this package:

  * the mechanisms' detector footprints form a sparse parity-check
    matrix ``A [D, N]`` (one column per mechanism);
  * mechanism probabilities become the per-column channel prior;
  * the observable footprints form ``O [k, N]``, and the decoder's
    output is the predicted observable flips ``O @ x_hat (mod 2)``.

:func:`load_dem` parses the flattened text DEM format (``error(p) D0 D1
L0`` lines, as stim's ``DetectorErrorModel.flattened()`` prints them)
without an external dependency; mechanisms with identical footprints are
merged by XOR probability.  It is the reference's parser, line for line.
"""

from __future__ import annotations

import numpy as np

from ..config import DecoderConfig
from .base import Decoder

__all__ = ["DetectorGraphDecoder", "load_dem"]


def load_dem(text_or_path):
    """Parse a flattened detector-error-model text file.

    Supported statements (one per line; ``#``/``//`` comments and blank
    lines ignored):

      * ``error(p) T1 T2 ...`` — an independent error mechanism with
        probability ``p`` flipping detector targets ``D<k>`` and
        logical-observable targets ``L<k>``.  ``^`` separator tokens
        (suggested decompositions) are ignored — the mechanism is taken
        whole, with a target repeated across components cancelling by
        parity (flipped twice = not flipped).  Mechanisms with
        identical footprints merge via ``p = p1(1-p2) + p2(1-p1)``
        (independent-XOR combination).  Mechanisms that can never fire
        (``p == 0`` after merging) or touch nothing are dropped; a
        deterministic ``p == 1`` mechanism raises (fold certain flips
        into the frame upstream); an observable-flipping mechanism with
        no detector footprint warns (undetectable logical error).
      * ``detector(...) D<k>`` / ``logical_observable L<k>`` —
        declarations; only consulted to size the outputs.
      * ``repeat N { ... }`` — the body executes ``N`` times (closing
        brace on its own line, as stim prints).
      * ``shift_detectors(coords) N`` / ``shift_detectors N`` — adds
        ``N`` to the running detector offset applied to every later
        ``D<k>`` reference (coordinates are metadata, ignored).  The
        offset accumulates across repeat iterations, so UNFLATTENED
        stim models parse directly and produce the same mechanisms as
        their flattened form (tested).

    Returns ``(A, priors, O)``: ``A`` scipy.sparse csr ``[D, N]`` uint8,
    ``priors`` float64 ``[N]``, ``O`` dense uint8 ``[k, N]`` (``k`` may
    be 0).
    """
    import os
    import re

    import scipy.sparse as sp

    text = text_or_path
    if (isinstance(text_or_path, (str, os.PathLike))
            and "\n" not in str(text_or_path)
            and os.path.exists(text_or_path)):
        with open(text_or_path) as f:
            text = f.read()

    lines = []
    for raw in str(text).splitlines():
        line = raw.split("#", 1)[0].split("//", 1)[0].strip()
        if line:
            lines.append(line)

    def parse_block(i, depth):
        """lines[i:] -> (statements, next_i); a statement is the line
        string or ("repeat", count, body)."""
        stmts = []
        while i < len(lines):
            line = lines[i]
            if line == "}":
                if depth == 0:
                    raise ValueError("unmatched '}' in DEM")
                return stmts, i + 1
            if line.split()[0] == "repeat":
                m = re.match(r"^repeat\s+(\d+)\s*\{$", line)
                if not m:
                    raise ValueError(
                        f"malformed repeat statement: {line!r} "
                        "(expected 'repeat N {{')")
                body, i = parse_block(i + 1, depth + 1)
                stmts.append(("repeat", int(m.group(1)), body))
                continue
            stmts.append(line)
            i += 1
        if depth:
            raise ValueError("unterminated repeat block in DEM")
        return stmts, i

    program, _ = parse_block(0, 0)

    mechanisms: dict[tuple, float] = {}
    max_d = max_l = -1
    offset = 0  # running shift_detectors offset applied to D targets
    err_re = re.compile(r"^error\s*\(\s*([0-9.eE+-]+)\s*\)\s*(.*)$")
    shift_re = re.compile(r"^shift_detectors(?:\s*\([^)]*\))?\s+(\d+)$")

    def execute(stmts):
        nonlocal max_d, max_l, offset
        for stmt in stmts:
            if isinstance(stmt, tuple):  # ("repeat", n, body)
                for _ in range(stmt[1]):
                    execute(stmt[2])
                continue
            line = stmt
            m = err_re.match(line)
            if m:
                p = float(m.group(1))
                if not 0.0 <= p <= 1.0:
                    raise ValueError(
                        f"error probability out of range: {line!r}")
                dets, obs = set(), set()
                for tok in m.group(2).split():
                    if tok == "^":
                        continue  # decomposition separator: take the whole
                    if tok[0] == "D":
                        # parity: flipped twice = not flipped
                        dets ^= {offset + int(tok[1:])}
                    elif tok[0] == "L":
                        obs ^= {int(tok[1:])}
                    else:
                        raise ValueError(
                            f"unknown error target {tok!r} in {line!r}")
                key = (tuple(sorted(dets)), tuple(sorted(obs)))
                if dets:
                    max_d = max(max_d, *dets)
                if obs:
                    max_l = max(max_l, *obs)
                q = mechanisms.get(key, 0.0)
                mechanisms[key] = q * (1 - p) + p * (1 - q)
                continue
            head = line.split("(")[0].split()[0]
            if head == "detector":
                ds = [offset + int(t[1:])
                      for t in line.split() if t[0] == "D"]
                if ds:
                    max_d = max(max_d, *ds)
                continue
            if head == "logical_observable":
                ls = [int(t[1:]) for t in line.split() if t[0] == "L"]
                if ls:
                    max_l = max(max_l, *ls)
                continue
            if head == "shift_detectors":
                m = shift_re.match(line)
                if not m:
                    raise ValueError(
                        f"malformed shift_detectors statement: {line!r}")
                offset += int(m.group(1))
                continue
            raise ValueError(f"unrecognized DEM statement: {line!r}")

    execute(program)

    # mechanisms that can never fire (p == 0 after merging — stim keeps
    # explicit error(0) instructions in flattened output) and footprint-free
    # no-ops (no detectors, no observables) are dropped so any valid
    # flattened DEM round-trips through DetectorGraphDecoder's strict
    # (0, 1) prior check; a deterministic p == 1 mechanism has no BP prior
    # representation and should be folded into the frame upstream
    mechanisms = {k: p for k, p in mechanisms.items()
                  if p > 0.0 and k != ((), ())}
    for (dets, obs), p in mechanisms.items():
        if p >= 1.0:
            raise ValueError(
                f"deterministic error mechanism (p=1) on D{list(dets)} "
                f"L{list(obs)}: fold certain flips into the detector/"
                "observable frame before decoding")
        if obs and not dets:
            import warnings

            warnings.warn(
                f"mechanism with p={p:g} flips observable(s) {sorted(obs)} "
                "but NO detectors — it is invisible to the decoder, which "
                "will mispredict those observables with at least that "
                "probability", stacklevel=2)
    if not mechanisms:
        raise ValueError("no error mechanisms in the model")
    D, K = max_d + 1, max_l + 1
    N = len(mechanisms)
    rows, cols = [], []
    O = np.zeros((K, N), np.uint8)
    priors = np.empty(N, np.float64)
    for j, ((dets, obs), p) in enumerate(sorted(mechanisms.items())):
        priors[j] = p
        rows.extend(dets)
        cols.extend([j] * len(dets))
        for L in obs:
            O[L, j] = 1
    A = sp.csr_matrix(
        (np.ones(len(rows), np.uint8), (rows, cols)), shape=(D, N))
    return A, priors, O


class DetectorGraphDecoder(Decoder):
    """Decode arbitrary detector error models.

    Args:
      A: ``[D, N]`` detector matrix — ``A[d, j] = 1`` iff mechanism
        ``j`` flips detector ``d`` (dense or scipy.sparse).
      priors: ``[N]`` per-mechanism probabilities.
      max_iters: BP iteration cap.
      observables: optional ``[k, N]`` observable matrix — mechanism
        ``j`` flips logical observable ``i`` iff ``O[i, j] = 1``.
      decoder: inner decoder kind (prior-capable; "bposd" default gives
        detector-consistent estimates).
      device: where decoding runs; None is the current CUDA card.
      **knobs: extra DecoderConfig fields (osd_order, ...).

    A full :class:`~.base.Decoder`: ``m = D`` (detector record length),
    ``n = N`` (mechanism count).  Build directly from a flattened DEM
    text/file with :meth:`from_dem`.
    """

    def __init__(self, A, priors, max_iters: int, *, observables=None,
                 decoder: str = "bposd", device=None, **knobs):
        super().__init__()
        import scipy.sparse as sp

        A = sp.csr_matrix(A).astype(np.uint8)
        self.D, self.N = A.shape
        priors = np.asarray(priors, np.float64)
        if priors.shape != (self.N,):
            raise ValueError(
                f"priors must be [{self.N}] (one per mechanism/column), "
                f"got {priors.shape}")
        if np.any(priors <= 0.0) or np.any(priors >= 1.0):
            raise ValueError("mechanism priors must lie strictly in (0, 1)")
        self.A = A
        self._prior = priors
        self.O = (None if observables is None
                  else np.asarray(observables, np.uint8) % 2)
        if self.O is not None and self.O.shape[1] != self.N:
            raise ValueError(
                f"observables must be [k, {self.N}], got {self.O.shape}")
        if self.O is not None:
            # an observable-flipping mechanism with an empty detector
            # footprint is undetectable: the decoder can never assign it
            col_wt = np.asarray(A.sum(axis=0)).ravel()
            bad = np.flatnonzero((col_wt == 0) & (self.O.sum(axis=0) > 0))
            if bad.size:
                import warnings

                warnings.warn(
                    f"{bad.size} mechanism(s) (columns {bad[:8].tolist()}"
                    f"{'...' if bad.size > 8 else ''}) flip observables but "
                    "no detectors — undetectable logical errors the decoder "
                    "cannot correct", stacklevel=2)
        cfg = DecoderConfig(kind=decoder, per=float(priors.mean()),
                            max_iters=max_iters, **knobs)
        build_input = A
        if decoder == "bposd" and self.D * self.N > 4_000_000:
            # TannerGraph attaches the dense rows OSD needs only up to 4M
            # entries; a circuit-level DEM (e.g. bb144 R=6 is 864 x 31,648)
            # sits above that, so densify deliberately here
            if self.D * self.N > 400_000_000:
                raise ValueError(
                    f"detector matrix {self.D}x{self.N} is too large to "
                    "densify for OSD; use a non-OSD decoder kind (bp, "
                    "minsum, ...) for models at this scale")
            build_input = np.asarray(A.todense())
        self.inner = cfg.build(build_input, device=device)
        self.device = self.inner.device
        # Decoder contract: m = input record length, n = output length
        self.m, self.n = self.D, self.N

    @classmethod
    def from_dem(cls, text_or_path, max_iters: int, *, decoder: str = "bposd",
                 device=None, **knobs):
        """Build from a flattened DEM (see :func:`load_dem`)."""
        A, priors, O = load_dem(text_or_path)
        return cls(A, priors, max_iters, observables=O, decoder=decoder, device=device,
                   **knobs)

    def _decode_batch(self, detectors, seed: int = 0, per=None):
        """Detector records ``[B, D]`` -> mechanism estimates ``[B, N]``.
        The DEM's per-mechanism priors are the default channel prior;
        ``per`` overrides them (scalar or ``[N]``)."""
        prior = self._prior if per is None else per
        return self.inner._decode_batch(detectors, seed, per=prior)

    def batch_decode(self, detectors, *, seed: int = 0, per=None):
        """Decode detector records ``[B, D]``; returns
        ``(mechanisms [B, N] int8, converged [B] bool)``."""
        detectors = np.asarray(detectors)
        if detectors.ndim != 2 or detectors.shape[1] != self.D:
            raise ValueError(
                f"expected detectors of shape [B, {self.D}], got "
                f"{detectors.shape}")
        return super().batch_decode(detectors, seed=seed, per=per)

    def predict_observables(self, detectors, *, seed: int = 0):
        """The sampler-facing call: decode and project onto the logical
        observables.  Returns ``(obs_flips [B, k] uint8, converged)``."""
        if self.O is None:
            raise ValueError("no observables matrix was provided")
        x, conv = self.batch_decode(detectors, seed=seed)
        flips = (x.astype(np.uint8) @ self.O.T) & 1
        return flips, conv
