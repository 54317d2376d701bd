"""Circuit-level noise: syndrome-extraction circuits and exact DEMs.

Counterpart of ``ldpcdecoders_tpu/codes/circuit.py``, carried unchanged
(numpy and scipy): the same circuits, the same detector error models and
the same shot draws for a seed.

The detector machinery (:mod:`..models.detector`) decodes *any*
detector error model, but round 2 only ever fed it hand-written toy
DEMs.  This module closes the loop without external dependencies: it
builds the standard CSS **memory experiment** circuit (rounds of
ancilla-based stabilizer extraction under uniform circuit-level
depolarizing noise, stim's ``surface_code:rotated_memory_z`` recipe)
for ANY CSS pair ``(Hx, Hz)``, and extracts its exact detector error
model by symplectic Pauli-fault propagation — every elementary fault
(each depolarizing component of each gate, every measurement/reset
flip) is pushed through the remainder of the circuit as a Pauli frame,
its flipped measurements are mapped to detector/observable footprints,
and identical footprints merge by independent-XOR probability.  That
is precisely the computation stim performs for independent Pauli
channels, so the emitted text (:func:`dem_text`) is a *real*
circuit-level DEM in the flattened stim format, parseable by
:func:`~..models.detector.load_dem`.

The same frame engine, seeded with random faults instead of unit
faults, is the **shot sampler** (:func:`sample_circuit`): detector
records drawn from the circuit itself, the honest input for end-to-end
decoder evaluation (decode circuit shots with DEM priors, compare
predicted vs actual observable flips — the sinter interface).

Everything here is host-side model *construction*; decoding runs on
the card through :class:`~..models.detector.DetectorGraphDecoder`.  The
propagation is vectorised over faults/shots (bool matrices ``[F, Q]``,
one pass over the op list), so bb144 x 6 rounds (~90k elementary
faults) extracts in seconds.

The Julia package this repo follows has no circuit-level tier; the
closest discipline is its real-quantum-code integration oracle
(test_bpots.jl:120-137).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "StabilizerCircuit",
    "css_memory_circuit",
    "circuit_dem",
    "dem_text",
    "sample_circuit",
]


class StabilizerCircuit:
    """A flat Clifford + Pauli-noise circuit with measurement records.

    Ops (appended by the small methods below):

      * ``("RZ", qs)`` — reset listed qubits to ``|0>``
      * ``("H", qs)`` — Hadamard
      * ``("CX", cs, ts)`` — disjoint controlled-X pairs (one layer)
      * ``("MRZ", qs)`` / ``("MZ", qs)`` — Z measurement (with/without
        reset), assigning consecutive global measurement indices
      * ``("XERR", p, qs)`` — independent X flip (measurement/reset
        noise)
      * ``("DEP1", p, qs)`` — single-qubit depolarizing (X/Y/Z at p/3)
      * ``("DEP2", p, cs, ts)`` — two-qubit depolarizing (15 Paulis at
        p/15)

    ``detectors`` / ``observables`` hold lists of *global measurement
    indices* whose XOR defines each detector / logical observable —
    deterministically zero / +1 in the noiseless circuit by
    construction (verified against the tableau simulator in tests).
    """

    def __init__(self, n_qubits: int):
        self.n_qubits = int(n_qubits)
        self.ops: list[tuple] = []
        self.n_meas = 0
        self.detectors: list[list[int]] = []
        self.observables: list[list[int]] = []

    # -- appending ops ------------------------------------------------------

    def _qs(self, qs):
        a = np.atleast_1d(np.asarray(qs, np.int32))
        if a.size and (a.min() < 0 or a.max() >= self.n_qubits):
            raise ValueError("qubit index out of range")
        return a

    def rz(self, qs):
        self.ops.append(("RZ", self._qs(qs)))

    def h(self, qs):
        self.ops.append(("H", self._qs(qs)))

    def cx(self, cs, ts):
        cs, ts = self._qs(cs), self._qs(ts)
        if len(cs) != len(ts):
            raise ValueError("CX needs equal-length control/target lists")
        touched = np.concatenate([cs, ts])
        if len(np.unique(touched)) != len(touched):
            raise ValueError("CX layer reuses a qubit")
        self.ops.append(("CX", cs, ts))

    def mrz(self, qs):
        qs = self._qs(qs)
        idx = np.arange(self.n_meas, self.n_meas + len(qs))
        self.n_meas += len(qs)
        self.ops.append(("MRZ", qs))
        return idx

    def mz(self, qs):
        qs = self._qs(qs)
        idx = np.arange(self.n_meas, self.n_meas + len(qs))
        self.n_meas += len(qs)
        self.ops.append(("MZ", qs))
        return idx

    def xerr(self, p, qs):
        if p > 0:
            self.ops.append(("XERR", float(p), self._qs(qs)))

    def dep1(self, p, qs):
        if p > 0:
            self.ops.append(("DEP1", float(p), self._qs(qs)))

    def dep2(self, p, cs, ts):
        if p > 0:
            self.ops.append(("DEP2", float(p), self._qs(cs), self._qs(ts)))

    def detector(self, meas_idx):
        self.detectors.append([int(i) for i in meas_idx])

    def observable(self, meas_idx):
        self.observables.append([int(i) for i in meas_idx])

    # -- derived structure ----------------------------------------------------

    def meas_maps(self):
        """Sparse ``[D, M]`` / ``[K, M]`` incidence of measurements in
        detectors / observables."""
        import scipy.sparse as sp

        def inc(groups):
            rows, cols = [], []
            for i, g in enumerate(groups):
                rows.extend([i] * len(g))
                cols.extend(g)
            return sp.csr_matrix(
                (np.ones(len(rows), np.uint8), (rows, cols)),
                shape=(len(groups), self.n_meas))

        return inc(self.detectors), inc(self.observables)


# 15 non-identity two-qubit Pauli components as (x1, z1, x2, z2) bits
_P2 = [(x1, z1, x2, z2)
       for x1 in (0, 1) for z1 in (0, 1)
       for x2 in (0, 1) for z2 in (0, 1)
       if (x1, z1, x2, z2) != (0, 0, 0, 0)]
_P1 = [(1, 0), (1, 1), (0, 1)]  # X, Y, Z


def _enumerate_faults(circ: StabilizerCircuit):
    """All elementary faults: returns ``probs [F]`` and per-op injection
    events ``{op_index: (rows, qubits, xs, zs)}`` (int32/bool arrays)."""
    probs: list[float] = []
    inject: dict[int, tuple] = {}
    for i, op in enumerate(circ.ops):
        kind = op[0]
        rows, qs, xs, zs = [], [], [], []
        base = len(probs)
        if kind == "XERR":
            p, targets = op[1], op[2]
            for q in targets:
                rows.append(len(probs)); qs.append(q); xs.append(1); zs.append(0)
                probs.append(p)
        elif kind == "DEP1":
            p, targets = op[1], op[2]
            for q in targets:
                for (x, z) in _P1:
                    rows.append(len(probs)); qs.append(q)
                    xs.append(x); zs.append(z)
                    probs.append(p / 3.0)
        elif kind == "DEP2":
            p, cs, ts = op[1], op[2], op[3]
            for a, b in zip(cs, ts):
                for (x1, z1, x2, z2) in _P2:
                    r = len(probs)
                    if x1 or z1:
                        rows.append(r); qs.append(a); xs.append(x1); zs.append(z1)
                    if x2 or z2:
                        rows.append(r); qs.append(b); xs.append(x2); zs.append(z2)
                    probs.append(p / 15.0)
        else:
            continue
        if len(probs) > base:
            inject[i] = (np.asarray(rows, np.int64), np.asarray(qs, np.int64),
                         np.asarray(xs, bool), np.asarray(zs, bool))
    return np.asarray(probs, np.float64), inject


def _frame_pass(circ: StabilizerCircuit, n_rows: int, inject_fn):
    """One vectorised pass of ``n_rows`` Pauli frames over the op list.

    ``inject_fn(op_index, op, X, Z)`` seeds noise (unit faults for DEM
    extraction, sampled faults for shot simulation).  Returns the
    measurement-flip events as a ``[n_rows, n_meas]`` scipy.sparse CSR.
    """
    import scipy.sparse as sp

    X = np.zeros((n_rows, circ.n_qubits), bool)
    Z = np.zeros((n_rows, circ.n_qubits), bool)
    ev_rows: list[np.ndarray] = []
    ev_meas: list[np.ndarray] = []
    meas = 0
    for i, op in enumerate(circ.ops):
        kind = op[0]
        if kind == "H":
            qs = op[1]
            t = X[:, qs].copy()
            X[:, qs] = Z[:, qs]
            Z[:, qs] = t
        elif kind == "CX":
            cs, ts = op[1], op[2]
            X[:, ts] ^= X[:, cs]
            Z[:, cs] ^= Z[:, ts]
        elif kind == "RZ":
            X[:, op[1]] = False
            Z[:, op[1]] = False
        elif kind in ("MRZ", "MZ"):
            qs = op[1]
            r, c = np.nonzero(X[:, qs])
            ev_rows.append(r)
            ev_meas.append(meas + c)
            meas += len(qs)
            if kind == "MRZ":
                X[:, qs] = False
                Z[:, qs] = False
        else:  # noise op
            inject_fn(i, op, X, Z)
    rows = np.concatenate(ev_rows) if ev_rows else np.empty(0, np.int64)
    cols = np.concatenate(ev_meas) if ev_meas else np.empty(0, np.int64)
    return sp.csr_matrix((np.ones(len(rows), np.uint8), (rows, cols)),
                         shape=(n_rows, circ.n_meas))


def circuit_dem(circ: StabilizerCircuit):
    """Extract the exact detector error model of ``circ``.

    Every elementary fault is propagated symplectically through the
    rest of the circuit; faults with identical (detector, observable)
    footprints merge via ``p <- p1(1-p2) + p2(1-p1)`` — exact for
    independent faults, the same rule stim's analyzer applies.  Faults
    that flip nothing are dropped.

    Returns ``(A, priors, O)`` in :func:`~..models.detector.load_dem`'s
    convention: sparse ``A [D, N]``, ``priors [N]``, dense ``O [K, N]``.
    """
    import scipy.sparse as sp

    probs, inject = _enumerate_faults(circ)

    def seed(i, op, X, Z):
        if i in inject:
            rows, qs, xs, zs = inject[i]
            X[rows, qs] ^= xs
            Z[rows, qs] ^= zs

    flips = _frame_pass(circ, len(probs), seed)
    Dinc, Oinc = circ.meas_maps()
    det_fp = (flips @ Dinc.T).tocsr()
    det_fp.data &= 1
    det_fp.eliminate_zeros()
    det_fp.sort_indices()  # footprint keys must be order-canonical
    obs_fp = (flips @ Oinc.T).tocsr()
    obs_fp.data &= 1
    obs_fp.eliminate_zeros()
    obs_fp.sort_indices()

    merged: dict[tuple, float] = {}
    for f in range(len(probs)):
        dets = tuple(
            int(d) for d in
            det_fp.indices[det_fp.indptr[f]:det_fp.indptr[f + 1]])
        obs = tuple(
            int(o) for o in
            obs_fp.indices[obs_fp.indptr[f]:obs_fp.indptr[f + 1]])
        if not dets and not obs:
            continue  # invisible fault (e.g. Z noise on a Z-basis qubit)
        key = (dets, obs)
        q = merged.get(key, 0.0)
        p = probs[f]
        merged[key] = q * (1 - p) + p * (1 - q)

    D, K = len(circ.detectors), len(circ.observables)
    N = len(merged)
    rows, cols = [], []
    O = np.zeros((K, N), np.uint8)
    pr = np.empty(N, np.float64)
    for j, ((dets, obs), p) in enumerate(sorted(merged.items())):
        pr[j] = p
        rows.extend(dets)
        cols.extend([j] * len(dets))
        for L in obs:
            O[L, j] = 1
    A = sp.csr_matrix((np.ones(len(rows), np.uint8), (rows, cols)),
                      shape=(D, N))
    return A, pr, O


def dem_text(circ: StabilizerCircuit, *, precision: int = 12) -> str:
    """The model of :func:`circuit_dem` as flattened stim-format text
    (``error(p) D.. L..`` lines plus declarations) — a real
    circuit-level DEM file for fixtures and interchange, round-tripping
    through :func:`~..models.detector.load_dem`."""
    A, pr, O = circuit_dem(circ)
    A = A.tocsc()
    A.sort_indices()
    lines = []
    for j in range(A.shape[1]):
        dets = A.indices[A.indptr[j]:A.indptr[j + 1]]
        toks = [f"D{d}" for d in dets]
        toks += [f"L{k}" for k in np.flatnonzero(O[:, j])]
        lines.append(f"error({pr[j]:.{precision}g}) " + " ".join(toks))
    lines += [f"detector D{d}" for d in range(len(circ.detectors))]
    lines += [f"logical_observable L{k}"
              for k in range(len(circ.observables))]
    return "\n".join(lines) + "\n"


def sample_circuit(circ: StabilizerCircuit, shots: int, *, seed: int = 0):
    """Monte-Carlo Pauli-frame sampling of the noisy circuit.

    Draws every noise channel independently per shot and propagates the
    joint frame; since all detectors/observables are deterministic in
    the noiseless circuit (tableau-verified in tests), the frame flips
    ARE the detector record.  Returns ``(detectors [S, D] uint8,
    obs_flips [S, K] uint8)`` — evaluation inputs drawn from the
    *circuit*, independent of the DEM approximation chain.
    """
    rng = np.random.default_rng(seed)

    def seed_fn(i, op, X, Z):
        kind = op[0]
        if kind == "XERR":
            p, qs = op[1], op[2]
            X[:, qs] ^= rng.random((X.shape[0], len(qs))) < p
        elif kind == "DEP1":
            p, qs = op[1], op[2]
            m = rng.random((X.shape[0], len(qs))) < p
            # r==1 -> X, r==2 -> Y, r==3 -> Z (0 where the channel idles)
            r = np.where(m, rng.integers(1, 4, m.shape), 0)
            X[:, qs] ^= (r == 1) | (r == 2)
            Z[:, qs] ^= (r == 2) | (r == 3)
        elif kind == "DEP2":
            p, cs, ts = op[1], op[2], op[3]
            m = rng.random((X.shape[0], len(cs))) < p
            r = np.where(m, rng.integers(1, 16, m.shape), 0)
            x1, z1 = (r >> 3) & 1, (r >> 2) & 1
            x2, z2 = (r >> 1) & 1, r & 1
            X[:, cs] ^= x1.astype(bool)
            Z[:, cs] ^= z1.astype(bool)
            X[:, ts] ^= x2.astype(bool)
            Z[:, ts] ^= z2.astype(bool)

    flips = _frame_pass(circ, int(shots), seed_fn)
    Dinc, Oinc = circ.meas_maps()
    det = np.asarray((flips @ Dinc.T).todense()) & 1
    obs = np.asarray((flips @ Oinc.T).todense()) & 1
    return det.astype(np.uint8), obs.astype(np.uint8)


def _cx_layers(H) -> list[tuple[np.ndarray, np.ndarray]]:
    """Greedy bipartite edge colouring of a stabilizer-support graph:
    layer ``k`` holds one (ancilla, data) coupling per qubit, so each
    layer is a legal disjoint CX round.  Bipartite graphs are
    max-degree-colourable (König), and greedy-by-ancilla stays within
    a small constant of that."""
    H = np.asarray(H.todense() if hasattr(H, "todense") else H) != 0
    m, n = H.shape
    anc_busy: list[set] = [set() for _ in range(m)]
    dat_busy: list[set] = [set() for _ in range(n)]
    layers: dict[int, list[tuple[int, int]]] = {}
    for a in range(m):
        for q in np.flatnonzero(H[a]):
            k = 0
            while k in anc_busy[a] or k in dat_busy[q]:
                k += 1
            anc_busy[a].add(k)
            dat_busy[q].add(k)
            layers.setdefault(k, []).append((a, int(q)))
    out = []
    for k in sorted(layers):
        pairs = layers[k]
        out.append((np.asarray([p[0] for p in pairs], np.int32),
                    np.asarray([p[1] for p in pairs], np.int32)))
    return out


def css_memory_circuit(
    Hx,
    Hz,
    rounds: int,
    *,
    after_clifford_depolarization: float = 0.0,
    before_measure_flip_probability: float = 0.0,
    after_reset_flip_probability: float = 0.0,
    before_round_data_depolarization: float = 0.0,
    p: float | None = None,
    basis: str = "z",
) -> StabilizerCircuit:
    """The standard CSS memory experiment under uniform circuit-level
    depolarizing noise (stim's ``rotated_memory_z`` recipe, generalised
    to any CSS pair).

    Data qubits start in the ``basis`` eigenbasis; each of ``rounds``
    rounds extracts every X stabilizer (ancilla in ``|+>`` via H,
    CX ancilla->data layers from :func:`_cx_layers`, H, measure+reset)
    then every Z stabilizer (CX data->ancilla, measure+reset); finally
    all data qubits are measured in ``basis``.  Detectors compare
    consecutive same-ancilla measurements (plus the deterministic
    first-round and final data-reconstruction comparisons of the
    ``basis`` type); observables are the code's ``basis``-type logical
    operators read off the final data measurements.

    Noise (the four stim generated-circuit knobs; ``p`` sets all four):
    ``DEPOLARIZE2(p)`` after every CX, ``DEPOLARIZE1(p)`` after every H,
    ``X_ERROR(p)`` before every measurement and after every reset, and
    ``DEPOLARIZE1(p)`` on all data at the start of each round.

    ``basis="x"`` runs the dual experiment (data in ``|+>``, final
    X-basis readout) on the same engine by conjugating the whole
    circuit with data-qubit Hadamards (equivalent and simpler than a
    second code path).
    """
    if p is not None:
        after_clifford_depolarization = p
        before_measure_flip_probability = p
        after_reset_flip_probability = p
        before_round_data_depolarization = p
    if basis not in ("z", "x"):
        raise ValueError("basis must be 'z' or 'x'")
    if basis == "x":
        # dual experiment: swap the roles of the two stabilizer types
        return css_memory_circuit(
            Hz, Hx, rounds,
            after_clifford_depolarization=after_clifford_depolarization,
            before_measure_flip_probability=before_measure_flip_probability,
            after_reset_flip_probability=after_reset_flip_probability,
            before_round_data_depolarization=before_round_data_depolarization,
            basis="z")

    from ..utils.metrics import css_logical_operators

    Hx_d = np.asarray(Hx.todense() if hasattr(Hx, "todense") else Hx) % 2
    Hz_d = np.asarray(Hz.todense() if hasattr(Hz, "todense") else Hz) % 2
    mx, n = Hx_d.shape
    mz = Hz_d.shape[0]
    if Hz_d.shape[1] != n:
        raise ValueError("Hx/Hz column counts differ")
    if np.any((Hx_d @ Hz_d.T) % 2):
        raise ValueError("Hx @ Hz.T != 0: not a CSS pair")
    R = int(rounds)
    if R < 1:
        raise ValueError("rounds must be >= 1")
    # Z-type logicals (in ker(Hx), modulo rowspan(Hz)): the memory-z
    # observables, read from the final data Z measurements
    Lz = css_logical_operators(Hz_d, Hx_d)

    acd = after_clifford_depolarization
    bmf = before_measure_flip_probability
    arf = after_reset_flip_probability
    brd = before_round_data_depolarization

    data = np.arange(n)
    zanc = n + np.arange(mz)
    xanc = n + mz + np.arange(mx)
    c = StabilizerCircuit(n + mz + mx)

    zlayers = [(zanc[a], data[q]) for a, q in _cx_layers(Hz_d)]
    xlayers = [(xanc[a], data[q]) for a, q in _cx_layers(Hx_d)]

    c.rz(data)
    c.xerr(arf, data)
    c.rz(np.concatenate([zanc, xanc]))
    c.xerr(arf, np.concatenate([zanc, xanc]))

    z_meas = np.empty((R, mz), np.int64)
    x_meas = np.empty((R, mx), np.int64)
    for r in range(R):
        c.dep1(brd, data)
        # X-stabilizer extraction
        c.h(xanc)
        c.dep1(acd, xanc)
        for cs, ts in xlayers:
            c.cx(cs, ts)  # ancilla (control) -> data
            c.dep2(acd, cs, ts)
        c.h(xanc)
        c.dep1(acd, xanc)
        c.xerr(bmf, xanc)
        x_meas[r] = c.mrz(xanc)
        c.xerr(arf, xanc)
        # Z-stabilizer extraction
        for cs, ts in zlayers:
            c.cx(ts, cs)  # data (control) -> ancilla
            c.dep2(acd, ts, cs)
        c.xerr(bmf, zanc)
        z_meas[r] = c.mrz(zanc)
        c.xerr(arf, zanc)
        # detectors: Z first round is deterministic (|0..0> is a +1
        # eigenstate); X starts at the first repeat comparison
        for i in range(mz):
            c.detector([z_meas[r, i]] if r == 0
                       else [z_meas[r - 1, i], z_meas[r, i]])
        if r > 0:
            for i in range(mx):
                c.detector([x_meas[r - 1, i], x_meas[r, i]])
    c.xerr(bmf, data)
    d_meas = c.mz(data)
    # final reconstruction: each Z stabilizer's data-measurement parity
    # must equal its last ancilla measurement
    for i in range(mz):
        c.detector([z_meas[R - 1, i]]
                   + [int(d_meas[q]) for q in np.flatnonzero(Hz_d[i])])
    for k in range(Lz.shape[0]):
        c.observable([int(d_meas[q]) for q in np.flatnonzero(Lz[k])])
    return c
