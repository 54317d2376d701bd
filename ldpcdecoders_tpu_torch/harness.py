"""FER/LER sweep harness with checkpoint/resume.

Counterpart of ``ldpcdecoders_tpu/harness.py``: batched decoding per
physical-error-rate point with accumulated trial and failure counts,
checkpointed to JSON after every batch so that a long sweep survives an
interruption (:class:`FERSweep`, :func:`find_threshold`), and the quantum
evaluations: the degeneracy-aware logical error rate of a CSS code pair
(:func:`css_logical_sweep`), of ``R`` noisy measurement rounds
(:func:`spacetime_logical_sweep`) and of a detector error model
(:func:`dem_logical_sweep`), and the frame-error rate of the mixed erasure +
bit-flip channel over erasure rates (:func:`mixed_fer_sweep`).

Every batch of a point draws from its own counted streams, derived from
``(seed, point, step)``.  Host sampling uses the reference's numpy streams,
so a host-sampled sweep gives the JAX package's counts wherever the decoder
is bitwise, and a checkpoint written by either package resumes in the other.
Device sampling draws from a ``torch.Generator`` seeded by the same
derivation: statistically equivalent to the reference's ``jax.random``
draws, not bitwise.

The route of each sweep (device or host sampling, counts reduced on the
device or on the host) is chosen up front from its inputs (a dense
matrix within ``_DEVICE_SWEEP_MAX_DENSE`` entries, ``on_device=``,
``sample_on_device=``, the decoder kind); an error in the chosen route
propagates.  Decoders run on the current CUDA card unless the sweep is
given ``device="cpu"`` (:class:`FERSweep` takes its decoders from the
caller's factory).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from .models.base import Decoder
from .utils.io import atomic_write_json, read_json
from .utils.metrics import wilson_interval
from .utils.noise import (sample_errors, sample_errors_device, sample_mixed_channel,
                          syndromes_of, verify_decodes)

__all__ = ["FERSweep", "SweepPoint", "find_threshold", "css_logical_sweep",
           "spacetime_logical_sweep", "dem_logical_sweep", "mixed_fer_sweep"]

# dense [m, n] size above which a device step would hold an unreasonable
# float32 operand: the sweeps then sample on the host
_DEVICE_SWEEP_MAX_DENSE = 50_000_000

#: the checkpoint key naming the noise sampler; the JAX package ignores it
SAMPLER_KEY = "sampler"
HOST_SAMPLER = "numpy.random.default_rng"
DEVICE_SAMPLER = "torch.Generator"

_MULTIHOST = ("multi-host sweeps need parallel/, which is not ported to "
              "ldpcdecoders_tpu_torch yet (ROADMAP.md queue 1 item 10)")


def _dense_f32(H, device) -> torch.Tensor:
    """``H`` (dense or scipy.sparse 0/1) as a float32 tensor on ``device``."""
    H = H.toarray() if hasattr(H, "toarray") else np.asarray(H)
    return torch.as_tensor((H != 0).astype(np.float32), device=device)


def _host_ints(t: torch.Tensor) -> list[int]:
    return [int(v) for v in t.cpu().tolist()]


@dataclasses.dataclass
class SweepPoint:
    """Accumulated statistics at one physical error rate."""

    per: float
    trials: int = 0
    steps: int = 0  # batches decoded; indexes this point's RNG streams
    exact_failures: int = 0  # estimate != injected error
    syndrome_mismatches: int = 0  # estimate does not reproduce syndrome
    non_converged: int = 0
    total_iters: int = 0
    wall_seconds: float = 0.0

    @property
    def ler(self) -> float:
        return self.exact_failures / self.trials if self.trials else 0.0

    @property
    def syndrome_match_rate(self) -> float:
        return 1.0 - (self.syndrome_mismatches / self.trials) if self.trials else 1.0

    @property
    def converged_fraction(self) -> float:
        return 1.0 - (self.non_converged / self.trials) if self.trials else 1.0

    def summary(self) -> dict:
        lo, hi = wilson_interval(self.exact_failures, self.trials)
        return {
            "per": self.per,
            "trials": self.trials,
            "ler": self.ler,
            "ler_ci95": [lo, hi],
            "syndrome_match_rate": self.syndrome_match_rate,
            "converged_fraction": self.converged_fraction,
            "mean_iters": self.total_iters / self.trials if self.trials else 0.0,
            "throughput_syndromes_per_s": (
                self.trials / self.wall_seconds if self.wall_seconds else 0.0
            ),
        }


class FERSweep:
    """Checkpointable frame-error-rate sweep over physical error rates.

    Args:
      H: parity-check matrix (dense, or scipy.sparse kept sparse).
      decoder_factory: ``per -> Decoder`` (the decoder's ``device`` is
        where its batches decode and, for a dense H, where the counts are
        reduced).  A decoder that takes ``per=`` overrides is built once,
        at the first point, and serves every point; the others are built
        per point.
      pers: physical error rates to sweep.
      batch: syndromes decoded per step.
      checkpoint_path: optional JSON path; progress is saved after every
        batch and picked up on restart.  The JSON is the reference's, field
        for field (``seed``, ``batch``, ``sample_on_device``, ``points``),
        plus ``sampler``, which the JAX package ignores.
      seed: base seed; each (point, batch) pair derives its own stream, so
        resumed runs reproduce the uninterrupted run exactly.
      multihost: None or False (one process).  True raises
        ``NotImplementedError``: multi-host sweeps are not ported.
      pipeline: batches in flight.  Each is dispatched with
        :meth:`~.models.base.Decoder.batch_decode_detailed_async` and its
        counts fetched in dispatch order, so the results are those of the
        synchronous loop.  1 disables overlap.
      sample_on_device: draw each batch's errors on the decoder's device
        from a ``torch.Generator`` seeded by the same (seed, point, step)
        derivation, build the syndromes there (an exact float32 matmul) and
        fetch only a ``[4]`` count vector.  Its streams are not the JAX
        package's, so such a checkpoint resumes only where ``sampler``
        names this package's sampler.  Needs a dense H within
        ``_DEVICE_SWEEP_MAX_DENSE`` entries.
    """

    def __init__(
        self,
        H,
        decoder_factory: Callable[[float], Decoder],
        pers: Sequence[float],
        *,
        batch: int = 256,
        checkpoint_path: str | None = None,
        seed: int = 0,
        multihost: bool | None = None,
        pipeline: int = 4,
        sample_on_device: bool = False,
    ):
        if multihost:
            raise NotImplementedError(_MULTIHOST)
        # keep scipy.sparse H as-is: syndromes_of handles it natively, and
        # densifying a from_edges-scale code here would allocate gigabytes
        self.H = H if hasattr(H, "toarray") else np.asarray(H)
        self.decoder_factory = decoder_factory
        self.batch = int(batch)
        self.checkpoint_path = checkpoint_path
        self.seed = int(seed)
        self.multihost = False
        self.pipeline = max(1, int(pipeline))
        self.sample_on_device = bool(sample_on_device)
        if self.sample_on_device and self.H.shape[0] * self.H.shape[1] > _DEVICE_SWEEP_MAX_DENSE:
            raise ValueError(
                f"sample_on_device needs H densified on the device; {self.H.shape} is past "
                f"{_DEVICE_SWEEP_MAX_DENSE} entries: sample on the host")
        self._dense_H: dict = {}  # device -> float32 H
        self.points = {float(p): SweepPoint(per=float(p)) for p in pers}
        if checkpoint_path and os.path.exists(checkpoint_path):
            self._load_checkpoint()

    # -- checkpointing ----------------------------------------------------

    def _load_checkpoint(self):
        data = read_json(self.checkpoint_path)
        if data.get("seed") != self.seed or data.get("batch") != self.batch:
            raise ValueError(
                "checkpoint was written with a different seed/batch config"
            )
        if bool(data.get("sample_on_device", False)) != self.sample_on_device:
            raise ValueError(
                "checkpoint was written with a different sampling mode "
                "(host vs device noise streams are not interchangeable)"
            )
        if self.sample_on_device and data.get(SAMPLER_KEY) != DEVICE_SAMPLER:
            raise ValueError(
                f"checkpoint's device-sampled noise came from another sampler "
                f"({data.get(SAMPLER_KEY, 'jax.random, written by ldpcdecoders_tpu')}); "
                f"its streams cannot be continued with {DEVICE_SAMPLER}")
        for rec in data["points"]:
            p = float(rec["per"])
            if p in self.points:
                self.points[p] = SweepPoint(**rec)

    def _save_checkpoint(self):
        if not self.checkpoint_path:
            return
        atomic_write_json(
            self.checkpoint_path,
            {
                "seed": self.seed,
                "batch": self.batch,
                "sample_on_device": self.sample_on_device,
                "points": [dataclasses.asdict(pt) for pt in self.points.values()],
                SAMPLER_KEY: DEVICE_SAMPLER if self.sample_on_device else HOST_SAMPLER,
            },
        )

    # -- running ----------------------------------------------------------

    def _H_on(self, device) -> torch.Tensor:
        if device not in self._dense_H:
            self._dense_H[device] = _dense_f32(self.H, device)
        return self._dense_H[device]

    def _device_verify(self, guesses, errs, syns, conv, iters) -> torch.Tensor:
        """The counts a sweep accumulates, reduced on the decoder's device
        (dense H): ``[4]`` int64 (exact failures, syndrome mismatches,
        non-converged, total iterations), one fetch a batch.  The float32
        matmul is exact (0/1 overlap counts far below 2^24)."""
        dev = guesses.device
        Hd = self._H_on(dev)
        errs = torch.as_tensor(errs, device=dev)
        syns = torch.as_tensor(syns, device=dev)
        exact = (guesses.to(torch.int8) == errs.to(torch.int8)).all(dim=1)
        synhat = torch.remainder(guesses.to(torch.float32) @ Hd.T, 2.0)
        smatch = (synhat == syns.to(torch.float32)).all(dim=1)
        return torch.stack([(~exact).sum(), (~smatch).sum(), (~conv).sum(),
                            iters.to(torch.int64).sum()])

    def _device_step(self, decoder, per_kw: dict, per: float, b: int, noise_seed: int,
                     decode_seed: int) -> torch.Tensor:
        """Sample -> syndrome -> decode -> count on the decoder's device."""
        dev = decoder.device
        errs = sample_errors_device(noise_seed, b, self.H.shape[1], per, device=dev)
        syns = torch.remainder(errs.to(torch.float32) @ self._H_on(dev).T, 2.0).to(torch.uint8)
        guesses, conv, iters, _ = decoder.batch_decode_detailed_async(
            syns, seed=decode_seed, **per_kw)
        return self._device_verify(guesses, errs, syns, conv, iters)

    def run(self, *, trials_per_point: int, max_seconds: float | None = None):
        """Accumulate until every point has ``trials_per_point`` trials.

        Returns ``{per: summary_dict}``.  Safe to interrupt and re-run.
        """
        t_start = time.perf_counter()
        n = self.H.shape[1]
        dense = not hasattr(self.H, "tocsr")
        shared_decoder = None  # serves every point where per= overrides work
        depth = self.pipeline
        stopping = False
        for per, pt in self.points.items():
            decoder = None
            per_kw = {}
            per_hash = int(per * 1e9) & 0x7FFFFFFF
            inflight: list = []  # (kind, payload, b)
            inflight_trials = 0
            step_cursor = pt.steps  # dispatch stream index; pt.steps counts
            # finalized batches, so a crash re-runs in-flight batches on
            # their exact original streams
            mark = time.perf_counter()

            def finalize_one():
                nonlocal inflight_trials, mark
                kind, payload, b = inflight.pop(0)
                if kind == "dev":
                    v = _host_ints(payload)  # one [4] fetch
                    counts = dict(exact_failures=v[0], syndrome_mismatches=v[1],
                                  non_converged=v[2], total_iters=v[3])
                else:
                    (guesses, conv, iters, _aux), errs, syns = payload
                    exact, smatch = verify_decodes(self.H, errs, guesses.cpu().numpy(), syns)
                    counts = dict(exact_failures=int(b - exact.sum()),
                                  syndrome_mismatches=int(b - smatch.sum()),
                                  non_converged=int(b - int(conv.sum())),
                                  total_iters=int(iters.sum()))
                pt.trials += b
                pt.steps += 1
                pt.exact_failures += counts["exact_failures"]
                pt.syndrome_mismatches += counts["syndrome_mismatches"]
                pt.non_converged += counts["non_converged"]
                pt.total_iters += counts["total_iters"]
                now = time.perf_counter()
                pt.wall_seconds += now - mark
                mark = now
                inflight_trials -= b
                self._save_checkpoint()

            while pt.trials + inflight_trials < trials_per_point or inflight:
                want_more = (
                    not stopping
                    and pt.trials + inflight_trials < trials_per_point
                )
                if want_more and max_seconds is not None and (
                        time.perf_counter() - t_start > max_seconds):
                    stopping = True
                    want_more = False
                if stopping and not inflight:
                    break
                if not want_more or len(inflight) >= depth:
                    finalize_one()
                    continue
                if decoder is None:
                    if shared_decoder is not None:
                        decoder, per_kw = shared_decoder, {"per": per}
                    else:
                        decoder = self.decoder_factory(per)
                        if decoder.supports_per_override:
                            # pass per explicitly from the start so that
                            # every point decodes alike
                            shared_decoder, per_kw = decoder, {"per": per}
                # each batch consumes its own counted stream; tracking the
                # step explicitly (not trials // batch) keeps resumed runs
                # on fresh streams even after a partial final batch; the
                # decoder stream gets a salt so stochastic tie-breaking stays
                # disjoint from the injected noise
                step = step_cursor
                b = min(self.batch, trials_per_point - pt.trials - inflight_trials)
                rng = np.random.default_rng((self.seed, per_hash, step, 0))
                decode_seed = int(np.random.default_rng(
                    (self.seed, per_hash, step, 0, 0xDEC0DE)).integers(1 << 31))
                if self.sample_on_device:
                    noise_seed = int(np.random.default_rng(
                        (self.seed, per_hash, step, 0, 0x5A3D)).integers(1 << 31))
                    rec = ("dev", self._device_step(decoder, per_kw, per, b, noise_seed,
                                                    decode_seed))
                else:
                    errs = sample_errors(rng, b, n, per)
                    syns = syndromes_of(self.H, errs)
                    handles = decoder.batch_decode_detailed_async(syns, seed=decode_seed,
                                                                  **per_kw)
                    if dense:
                        # only a [4] vector crosses back (see _device_verify)
                        rec = ("dev", self._device_verify(handles[0], errs, syns, handles[1],
                                                          handles[2]))
                    else:
                        rec = ("host", (handles, errs, syns))
                inflight.append((*rec, b))
                inflight_trials += b
                step_cursor += 1
            if stopping:
                self._save_checkpoint()
                return self.summaries()
        return self.summaries()

    def summaries(self) -> dict:
        return {pt.per: pt.summary() for pt in self.points.values()}


def find_threshold(
    H,
    decoder_factory: Callable[[float], Decoder],
    *,
    target_ler: float = 1e-2,
    lo: float = 1e-4,
    hi: float = 0.2,
    trials_per_probe: int = 2000,
    batch: int = 256,
    seed: int = 0,
    rel_tol: float = 0.05,
    max_probes: int = 12,
) -> dict:
    """Bisect the physical error rate where the decoder's LER crosses
    ``target_ler``.

    LER(per) is monotone increasing for these channels, so a geometric
    bisection brackets the crossing: each probe runs a single-point
    :class:`FERSweep` (a re-run with the same seed reproduces the probe
    stream exactly) and moves the bracket endpoint the probe falls on.
    Stops when ``hi/lo <= 1 + rel_tol`` or after ``max_probes``.

    Returns ``{"threshold": geometric bracket midpoint, "lo": .., "hi": ..,
    "target_ler": .., "probes": [per-probe summaries]}``.
    """
    if not (0.0 < lo < hi):
        raise ValueError("need 0 < lo < hi")
    if not 0.0 < target_ler < 1.0:
        raise ValueError("target_ler must be in (0, 1)")
    probes = []
    for k in range(max_probes):
        if hi / lo <= 1.0 + rel_tol:
            break
        mid = float(np.sqrt(lo * hi))
        sweep = FERSweep(H, decoder_factory, [mid], batch=batch, seed=seed + k)
        summary = sweep.run(trials_per_point=trials_per_probe)[mid]
        probes.append(summary)
        if summary["ler"] >= target_ler:
            hi = mid
        else:
            lo = mid
    return {
        "threshold": float(np.sqrt(lo * hi)),
        "lo": float(lo),
        "hi": float(hi),
        "target_ler": float(target_ler),
        "probes": probes,
    }


# decoder kinds that take per-qubit priors (heralded loss, the space-time
# prior vector)
_PRIOR_CAPABLE = ("bp", "bposd", "minsum", "bpots")


def css_logical_sweep(
    Hx,
    Hz,
    pers: Sequence[float],
    *,
    trials_per_point: int,
    max_iters: int = 100,
    decoder: str = "bposd",
    batch: int = 256,
    seed: int = 0,
    loss_rate: float = 0.0,
    on_device: bool | None = None,
    pipeline: int = 4,
    max_seconds: float | None = None,
    device=None,
    **knobs,
) -> dict:
    """Degeneracy-aware logical-error-rate sweep of a CSS code pair.

    At each physical error rate independent X and Z error batches are
    injected, both stabilizer blocks are decoded
    (:class:`~.models.css.CSSDecoder`), and a lane counts as a logical
    failure when its residual (true XOR estimate) is not a stabilizer: it
    lies outside rowspan(Hz) for Z residuals, rowspan(Hx) for X ones.

    With ``loss_rate > 0`` each shot also loses that fraction of qubits
    (heralded erasure shared by both blocks; a lost qubit's X and Z
    components are uniform) and the decoders get the erasure mask through
    ``CSSDecoder.batch_decode(..., erasures=)``: this runs the host loop.
    The loss-free case of a prior-capable kind (unless ``on_device=False``)
    is the ``rounds=1`` space-time problem and runs
    :func:`spacetime_logical_sweep`'s device route.  ``device``: where the
    decoders run (None: the current CUDA card).

    RNG discipline matches FERSweep: each (point, batch) consumes its own
    counted stream derived from ``(seed, per, step)``.

    Returns ``{per: {"trials", "z_logical_rate", "x_logical_rate",
    "any_logical_rate", *_ci95, "z_converged", "x_converged",
    "throughput_pairs_per_s", ...}}``.
    """
    from .models.css import CSSDecoder

    Hx = np.asarray(Hx) if not hasattr(Hx, "tocsr") else Hx
    Hz = np.asarray(Hz) if not hasattr(Hz, "tocsr") else Hz
    n = Hx.shape[1]
    if loss_rate == 0.0 and on_device is not False and decoder in _PRIOR_CAPABLE:
        # perfect-measurement decoding is the rounds=1 space-time problem
        # (the same inner decoder), so the loss-free sweep shares its
        # device-resident pipeline
        res = spacetime_logical_sweep(
            Hx, Hz, pers, rounds=1, trials_per_point=trials_per_point,
            max_iters=max_iters, decoder=decoder, batch=batch, seed=seed,
            pipeline=pipeline, on_device=on_device, max_seconds=max_seconds,
            device=device, **knobs)
        out = {}
        for per, pt in res.items():
            pt = dict(pt)
            pt.pop("rounds", None)
            pt.pop("meas_error_rate", None)
            pt["throughput_pairs_per_s"] = pt.pop("throughput_shots_per_s")
            out[per] = pt
        return out
    # one decoder pair built at the first noise point, later points passed
    # as prior overrides; kinds without override support get a pair per
    # point
    shared = CSSDecoder(Hx, Hz, per=float(pers[0]), max_iters=max_iters,
                        decoder=decoder, device=device, **knobs)
    per_kw_ok = shared.x_block.supports_per_override
    if loss_rate > 0.0 and not (per_kw_ok and shared.x_block.supports_vector_prior):
        raise ValueError(
            f"loss_rate > 0 needs a prior-capable decoder kind; "
            f"'{decoder}' cannot honor erasure priors"
        )
    out = {}
    for per in pers:
        dec = shared
        if not per_kw_ok and per != pers[0]:
            dec = CSSDecoder(Hx, Hz, per=float(per), max_iters=max_iters,
                             decoder=decoder, device=device, **knobs)
        per_hash = int(per * 1e9) & 0x7FFFFFFF
        trials = zf_cnt = xf_cnt = anyf_cnt = zc_cnt = xc_cnt = 0
        step = 0
        t0 = time.perf_counter()
        while trials < trials_per_point:
            b = min(batch, trials_per_point - trials)
            rng = np.random.default_rng((seed, per_hash, step))
            decode_seed = int(
                np.random.default_rng(
                    (seed, per_hash, step, 0xDEC0DE)
                ).integers(1 << 31)
            )
            if loss_rate > 0.0:
                eps = rng.random((b, n)) < loss_rate
                z_true = np.where(eps, rng.random((b, n)) < 0.5,
                                  sample_errors(rng, b, n, per))
                x_true = np.where(eps, rng.random((b, n)) < 0.5,
                                  sample_errors(rng, b, n, per))
                eps_kw = {"erasures": eps}
            else:
                z_true = sample_errors(rng, b, n, per)
                x_true = sample_errors(rng, b, n, per)
                eps_kw = {}
            syn_x = syndromes_of(Hx, z_true)
            syn_z = syndromes_of(Hz, x_true)
            per_kw = {"per": float(per)} if per_kw_ok else {}
            z_hat, x_hat, zc, xc = dec.batch_decode(syn_x, syn_z, seed=decode_seed, **per_kw,
                                                    **eps_kw)
            zf, xf = dec.logical_failures(z_true, z_hat, x_true, x_hat)
            trials += b
            step += 1
            zf_cnt += int(zf.sum())
            xf_cnt += int(xf.sum())
            anyf_cnt += int((zf | xf).sum())
            zc_cnt += int(np.asarray(zc).sum())
            xc_cnt += int(np.asarray(xc).sum())
        dt = time.perf_counter() - t0
        z_lo, z_hi = wilson_interval(zf_cnt, trials)
        x_lo, x_hi = wilson_interval(xf_cnt, trials)
        a_lo, a_hi = wilson_interval(anyf_cnt, trials)
        out[per] = {
            "per": float(per),
            "trials": trials,
            "z_logical_rate": zf_cnt / trials,
            "z_logical_ci95": [z_lo, z_hi],
            "x_logical_rate": xf_cnt / trials,
            "x_logical_ci95": [x_lo, x_hi],
            "any_logical_rate": anyf_cnt / trials,
            "any_logical_ci95": [a_lo, a_hi],
            "z_converged": zc_cnt / trials,
            "x_converged": xc_cnt / trials,
            "throughput_pairs_per_s": trials / dt if dt else 0.0,
        }
    return out


def mixed_fer_sweep(
    H,
    p_flip: float,
    erasure_rates: Sequence[float],
    *,
    trials_per_point: int,
    max_iters: int = 60,
    batch: int = 256,
    seed: int = 0,
    algorithm: str = "minsum",
    strategy: str = "peel+bp",
    osd_order: int | None = None,
    checkpoint_path: str | None = None,
    max_seconds: float | None = None,
    device=None,
    **knobs,
) -> dict:
    """FER sweep over erasure rates on the mixed erasure + bit-flip channel.

    The mixed-channel analog of :class:`FERSweep`: at each erasure rate a
    batch of (erasure mask, error) pairs is drawn on the host
    (``utils.noise.sample_mixed_channel``: erased bits uniform, the rest
    flipped with ``p_flip``) from the counted stream ``(seed, point,
    step)`` of the reference, and decoded by one
    :class:`~.models.mixed.MixedChannelDecoder` on ``device`` (None: the
    current CUDA card).  The same streams give the reference's counts
    wherever the decoder is bitwise, and the checkpoint JSON is the
    reference's: a sweep resumes in either package.

    Returns ``{eps: {"trials", "exact_failure_rate", *_ci95,
    "syndrome_mismatch_rate", "ok_rate", "bp_engaged_steps",
    "mean_peel_rounds", "throughput_decodes_per_s"}}``;
    ``bp_engaged_steps`` counts the decode calls whose BP stage ran.
    ``checkpoint_path`` / ``max_seconds``: the counters are saved after
    every batch, a re-run resumes on the exact counted streams, and the
    sweep stops cleanly when the budget is spent.
    """
    from .models.mixed import MixedChannelDecoder

    dec = MixedChannelDecoder(H, p_flip, max_iters, algorithm=algorithm, strategy=strategy,
                              osd_order=osd_order, device=device, **knobs)
    n = dec.n
    _CNT = ("trials", "exact_fail", "smismatch", "not_ok", "bp_steps", "rounds_sum",
            "wall_seconds")
    state = {float(e): dict.fromkeys(_CNT + ("step",), 0) for e in erasure_rates}
    for st in state.values():
        st["wall_seconds"] = 0.0
    if checkpoint_path and os.path.exists(checkpoint_path):
        data = read_json(checkpoint_path)
        if (data.get("seed"), data.get("batch"), data.get("p_flip")) != (
                seed, batch, float(p_flip)):
            raise ValueError("checkpoint was written with a different seed/batch/p_flip config")
        for k, rec in data["points"].items():
            if float(k) in state:
                state[float(k)].update(rec)

    def save():
        if checkpoint_path:
            atomic_write_json(checkpoint_path, {
                "seed": seed, "batch": batch, "p_flip": float(p_flip),
                "points": {str(k): v for k, v in state.items()},
            })

    t_start = time.perf_counter()
    out = {}
    for eps in (float(e) for e in erasure_rates):
        st = state[eps]
        eps_hash = int(eps * 1e9) & 0x7FFFFFFF
        while st["trials"] < trials_per_point:
            if max_seconds is not None and time.perf_counter() - t_start >= max_seconds:
                break
            b = min(batch, trials_per_point - st["trials"])
            rng = np.random.default_rng((seed, eps_hash, st["step"]))
            erasures, errs = sample_mixed_channel(rng, b, n, p_flip, eps)
            syns = syndromes_of(H, errs)
            t0 = time.perf_counter()
            guesses, ok, peel_rounds, bp_iters = dec.batch_decode_detailed(syns, erasures)
            st["wall_seconds"] += time.perf_counter() - t0
            exact, smatch = verify_decodes(H, errs, guesses, syns)
            st["trials"] += b
            st["step"] += 1
            st["exact_fail"] += int(b - exact.sum())
            st["smismatch"] += int(b - smatch.sum())
            st["not_ok"] += int(b - ok.sum())
            st["bp_steps"] += int(bp_iters > 0)
            st["rounds_sum"] += int(peel_rounds.sum())
            save()
        trials = st["trials"]
        if not trials:
            continue
        lo, hi = wilson_interval(st["exact_fail"], trials)
        out[eps] = {
            "erasure_rate": eps,
            "p_flip": float(p_flip),
            "trials": trials,
            "exact_failure_rate": st["exact_fail"] / trials,
            "exact_failure_ci95": [lo, hi],
            "syndrome_mismatch_rate": st["smismatch"] / trials,
            "ok_rate": 1.0 - st["not_ok"] / trials,
            "bp_engaged_steps": st["bp_steps"],
            "steps": st["step"],
            "mean_peel_rounds": st["rounds_sum"] / trials,
            "throughput_decodes_per_s": (trials / st["wall_seconds"]
                                         if st["wall_seconds"] else 0.0),
        }
    return out


def _spacetime_sample(gen: torch.Generator, Hd: torch.Tensor, per, q, b: int, R: int):
    """Device-side phenomenological sampler: ``b`` shots of ``R`` noisy
    measurement rounds of the dense ``[m, n]`` float32 block ``Hd``.

    Fresh iid data errors at rate ``per`` per round, the cumulative error
    by an int32 cumsum, syndromes by one exact float32 matmul per history,
    readout flips at rate ``q`` everywhere except the (perfect) final round,
    and the XOR-difference detector record.  The data errors, then the
    readout flips, are drawn from ``gen``.

    Returns ``(cum_last [b, n] int32, detectors [b, R*m] uint8)``.
    """
    m, n = Hd.shape
    e = sample_errors_device(gen, b * R, n, per).reshape(b, R, n)
    cum = torch.cumsum(e.to(torch.int32), dim=1) & 1  # [b, R, n]
    syn = torch.remainder(cum.reshape(b * R, n).to(torch.float32) @ Hd.T, 2.0)
    syn = syn.to(torch.int32).reshape(b, R, m)
    u = sample_errors_device(gen, b * R, m, q).reshape(b, R, m).to(torch.int32)
    u[:, R - 1] = 0  # perfect final readout
    syn = syn ^ u
    det = torch.cat([syn[:, :1], syn[:, 1:] ^ syn[:, :-1]], dim=1)
    return cum[:, -1], det.reshape(b, R * m).to(torch.uint8)


class _SpacetimePairStep:
    """One evaluation batch of both blocks on the decoders' device: sample
    -> detectors -> decode -> degeneracy verdict -> count.

    The stabilizer-equivalence check is the
    :func:`~.utils.metrics.css_logical_operators` matmul form (a residual
    is a stabilizer iff ``H @ r == 0`` and ``L @ r == 0`` mod 2; both
    float32 products are exact), so only a ``[6]`` count vector leaves the
    device: ``[zfail, xfail, anyfail, zconv, xconv, iters]``.
    """

    def __init__(self, dec_x, dec_z, Hx, Hz, Lx, Lz):
        dev = dec_x.device
        self.dec_x, self.dec_z = dec_x, dec_z
        self.Hxd, self.Hzd = _dense_f32(Hx, dev), _dense_f32(Hz, dev)
        self.Lxd, self.Lzd = _dense_f32(Lx, dev), _dense_f32(Lz, dev)

    @staticmethod
    def _block(gen, dec, Hd, Ld, b, decode_seed, per, q):
        cum_last, det = _spacetime_sample(gen, Hd, per, q, b, dec.rounds)
        e_hat, conv, iters, _ = dec._call_decode(det, decode_seed, per, q)
        resid = (cum_last ^ e_hat.to(torch.int32)).to(torch.float32)
        fail = (torch.remainder(resid @ Hd.T, 2.0) != 0).any(dim=1)
        if Ld.shape[0]:
            fail = fail | (torch.remainder(resid @ Ld.T, 2.0) != 0).any(dim=1)
        return fail, conv, iters

    def __call__(self, b, noise_seed, decode_seed, per, q) -> torch.Tensor:
        gen = torch.Generator(device=self.dec_x.device)
        gen.manual_seed(int(noise_seed))
        zfail, zconv, zit = self._block(gen, self.dec_x, self.Hxd, self.Lxd, b, decode_seed,
                                        per, q)
        xfail, xconv, xit = self._block(gen, self.dec_z, self.Hzd, self.Lzd, b,
                                        decode_seed + 1, per, q)
        return torch.stack([zfail.sum(), xfail.sum(), (zfail | xfail).sum(), zconv.sum(),
                            xconv.sum(), zit.to(torch.int64).sum() + xit.to(torch.int64).sum()])


def spacetime_logical_sweep(
    Hx,
    Hz,
    pers: Sequence[float],
    *,
    rounds: int,
    trials_per_point: int,
    meas_error_rate: float | None = None,
    max_iters: int = 100,
    decoder: str = "bposd",
    batch: int = 256,
    seed: int = 0,
    pipeline: int = 4,
    on_device: bool | None = None,
    max_seconds: float | None = None,
    device=None,
    **knobs,
) -> dict:
    """Phenomenological-noise logical-error sweep: ``rounds`` noisy
    syndrome-measurement rounds per shot, decoded jointly over the
    space-time detector graph (:class:`~.models.spacetime.SpaceTimeDecoder`).

    Per shot and per stabilizer block, every round injects fresh iid data
    errors at rate ``per`` and flips each readout bit at rate
    ``meas_error_rate`` (default ``per``); the final round is read out
    perfectly.  A lane fails logically when the residual between the true
    cumulative error and the estimate is outside the opposite block's
    stabilizer rowspan.  ``rounds=1`` is css_logical_sweep's
    perfect-measurement setting.

    Route: with both blocks within ``_DEVICE_SWEEP_MAX_DENSE`` dense
    entries (or ``on_device=True``) each batch is sampled, decoded and
    verified on the decoders' device (:class:`_SpacetimePairStep`), with
    ``pipeline`` batches in flight and a ``[6]`` count fetch each; its
    noise comes from a ``torch.Generator`` keyed by the ``(seed, point,
    step)`` derivation.  Otherwise (or ``on_device=False``) the host loop
    samples numpy streams.  BP+OSD runs eagerly, as the reference's harness
    runs it (the compacting OSD gives the outputs of ``fused=True``).
    ``device``: where the decoders run (None: the current CUDA card).

    Returns ``{per: {"trials", "rounds", "z_logical_rate",
    "x_logical_rate", "any_logical_rate", *_ci95, "z_converged",
    "x_converged", "mean_iters", "throughput_shots_per_s",
    "device_sampled"}}``.
    """
    from .models.spacetime import SpaceTimeDecoder

    R = int(rounds)
    dense_ok = (Hx.shape[0] * Hx.shape[1] + Hz.shape[0] * Hz.shape[1]
                <= _DEVICE_SWEEP_MAX_DENSE)
    use_dev = dense_ok if on_device is None else bool(on_device)
    dec_kw = dict(meas_error_rate=meas_error_rate, decoder=decoder, device=device, **knobs)
    dec_x = SpaceTimeDecoder(Hx, R, float(pers[0]), max_iters, **dec_kw)
    dec_z = SpaceTimeDecoder(Hz, R, float(pers[0]), max_iters, **dec_kw)
    if use_dev:
        from .utils.metrics import css_logical_operators

        Lx = css_logical_operators(Hx, Hz)  # Z residuals vs rowspan(Hz)
        Lz = css_logical_operators(Hz, Hx)
        dev_step = _SpacetimePairStep(dec_x, dec_z, Hx, Hz, Lx, Lz)
    else:
        from .utils.metrics import gf2_rowspan_reducer

        z_span = gf2_rowspan_reducer(Hz)  # Z residuals must be Z stabilizers
        x_span = gf2_rowspan_reducer(Hx)
    n = dec_x.block_n
    depth = max(1, int(pipeline)) if use_dev else 1
    t_start = time.perf_counter()
    out = {}
    for per in pers:
        q = float(per) if meas_error_rate is None else float(meas_error_rate)
        per_hash = int(per * 1e9) & 0x7FFFFFFF
        trials = zf = xf = anyf = zc = xc = iters_sum = 0
        step = 0
        inflight: list = []  # (counts, b)
        t0 = time.perf_counter()

        def finalize_one():
            nonlocal trials, zf, xf, anyf, zc, xc, iters_sum, inflight_trials
            v, b = inflight.pop(0)
            v = _host_ints(v) if isinstance(v, torch.Tensor) else [int(x) for x in v]
            trials += b
            inflight_trials -= b
            zf += v[0]
            xf += v[1]
            anyf += v[2]
            zc += v[3]
            xc += v[4]
            iters_sum += v[5]

        inflight_trials = 0
        stopping = False
        while trials + inflight_trials < trials_per_point or inflight:
            if max_seconds is not None and not stopping and (
                    time.perf_counter() - t_start) >= max_seconds:
                stopping = True
            if stopping and not inflight:
                break
            want_more = (not stopping
                         and trials + inflight_trials < trials_per_point)
            if not want_more or len(inflight) >= depth:
                finalize_one()
                continue
            b = min(batch, trials_per_point - trials - inflight_trials)
            rng = np.random.default_rng((seed, per_hash, step))
            decode_seed = int(np.random.default_rng(
                (seed, per_hash, step, 0xDEC0DE)).integers(1 << 31))
            if use_dev:
                noise_seed = int(np.random.default_rng(
                    (seed, per_hash, step, 0x5A3D)).integers(1 << 31))
                counts = dev_step(b, noise_seed, decode_seed, float(per), q)
            else:
                counts = _spacetime_host_step(
                    dec_x, dec_z, Hx, Hz, z_span, x_span, rng, decode_seed,
                    b, R, n, float(per), q)
            inflight.append((counts, b))
            inflight_trials += b
            step += 1
        dt = time.perf_counter() - t0
        if not trials:
            continue
        z_lo, z_hi = wilson_interval(zf, trials)
        x_lo, x_hi = wilson_interval(xf, trials)
        a_lo, a_hi = wilson_interval(anyf, trials)
        out[per] = {
            "per": float(per),
            "meas_error_rate": q,
            "rounds": R,
            "trials": trials,
            "z_logical_rate": zf / trials,
            "z_logical_ci95": [z_lo, z_hi],
            "x_logical_rate": xf / trials,
            "x_logical_ci95": [x_lo, x_hi],
            "any_logical_rate": anyf / trials,
            "any_logical_ci95": [a_lo, a_hi],
            "z_converged": zc / trials,
            "x_converged": xc / trials,
            "mean_iters": iters_sum / (2 * trials),
            "throughput_shots_per_s": trials / dt if dt else 0.0,
            "device_sampled": bool(use_dev),
        }
        if stopping:
            break
    return out


def _spacetime_host_step(dec_x, dec_z, Hx, Hz, z_span, x_span, rng,
                         decode_seed, b, R, n, per, q):
    """Host-sampled batch (numpy counted streams, the reference's host
    loop).  Returns the same [6] counts as the device step."""
    from .codes.spacetime import detectors_of

    def run(dec, H_det, span, s_off):
        # fresh errors per round -> cumulative -> noisy syndromes
        e = sample_errors(rng, b * R, n, per).reshape(b, R, n)
        cum = (np.cumsum(e, axis=1) & 1).astype(np.uint8)
        syn = np.stack([syndromes_of(H_det, cum[:, r]) for r in range(R)],
                       axis=1)
        u = sample_errors(rng, b * R, dec.block_m, q).reshape(
            b, R, dec.block_m)
        u[:, -1] = 0  # perfect final readout
        syn ^= u.astype(np.uint8)
        det = detectors_of(syn)
        e_hat, conv, iters, _, _ = dec.batch_decode_detailed(
            det, seed=decode_seed + s_off, per=per, q=q)
        resid = cum[:, -1] ^ np.asarray(e_hat).astype(np.uint8)
        return ~span(resid), np.asarray(conv), int(np.asarray(iters).sum())

    zfail, zconv, zit = run(dec_x, Hx, z_span, 0)  # Hx detects Z errors
    xfail, xconv, xit = run(dec_z, Hz, x_span, 1)
    return np.array([zfail.sum(), xfail.sum(), (zfail | xfail).sum(),
                     zconv.sum(), xconv.sum(), zit + xit], np.int64)


def dem_logical_sweep(
    dem,
    *,
    shots: int = 100_000,
    max_iters: int = 60,
    decoder: str = "bposd",
    batch: int = 2048,
    seed: int = 0,
    rounds: int | None = None,
    pipeline: int = 4,
    on_device: bool | None = None,
    circuit=None,
    max_seconds: float | None = None,
    device=None,
    **knobs,
) -> dict:
    """Observable-prediction error rate of a detector error model: the
    sinter-style evaluation for circuit-level decoding.

    ``dem`` is a flattened DEM path or text, an ``(A, priors, O)`` triple,
    or a ready :class:`~.models.detector.DetectorGraphDecoder` (or
    :class:`~.models.staged.StagedDemDecoder`; ``decoder="staged"`` builds
    one, which evaluates through its own ``run_eval``).

    Route, chosen up front: without ``circuit=`` and with ``A`` within
    ``_DEVICE_SWEEP_MAX_DENSE`` dense entries (or ``on_device=True``), each
    batch samples a mechanism vector per lane from the DEM priors on the
    decoder's device (``torch.Generator``), builds the detector records by
    an exact float32 matmul, decodes, and compares the true and predicted
    observable flips there: a ``[2]`` count fetch a batch, ``pipeline``
    batches in flight.  Otherwise batches are sampled on the host from
    ``np.random.default_rng((seed, step))``; with ``circuit=`` (a
    :class:`~.codes.circuit.StabilizerCircuit`) the shots are drawn from the
    circuit itself by :func:`~.codes.circuit.sample_circuit`, the
    model-independent ground truth.  BP+OSD runs eagerly, as the reference's
    harness runs it.  ``device``: where a decoder built here runs (None: the current
    CUDA card).

    ``rounds`` is metadata: when given, the summary adds the per-round rate
    ``1 - (1 - LER)^(1/rounds)``.

    Returns ``{"shots", "fails", "logical_rate", "logical_ci95",
    "per_round_rate"?, "converged", "throughput_shots_per_s",
    "device_sampled"}``.
    """
    from .models.detector import DetectorGraphDecoder, load_dem
    from .models.staged import StagedDemDecoder, draw_mechanisms

    if isinstance(dem, StagedDemDecoder) or decoder == "staged":
        # the staged production path carries its own pipelined evaluator
        if isinstance(dem, StagedDemDecoder):
            sdec = dem
        else:
            A, priors, O = dem if isinstance(dem, tuple) else load_dem(dem)
            knobs.setdefault("stage0_iters", min(max_iters, 96))
            knobs.setdefault("deep_iters", max_iters)
            osd_order = knobs.pop("osd_order", 0)
            if osd_order:  # bposd-style knob: the OSD-CS pair depth
                knobs.setdefault("lam", osd_order)
            sdec = StagedDemDecoder(A, priors, observables=O, device=device, **knobs)
        if circuit is not None:
            # circuit-sampled ground truth: host sampling, staged decode
            from .codes.circuit import sample_circuit

            det, obs = sample_circuit(circuit, shots, seed=seed)
            t0 = time.perf_counter()
            fails = convd = done = 0
            while done < shots:
                d = det[done: done + batch]
                o = obs[done: done + batch]
                pred, conv = sdec.predict_observables(d, seed=seed + done)
                fails += int((pred != o).any(axis=1).sum())
                convd += int(np.asarray(conv).sum())
                done += len(d)
            dt = time.perf_counter() - t0
            lo, hi = wilson_interval(fails, done)
            out = {"shots": done, "fails": fails,
                   "logical_rate": fails / done,
                   "logical_ci95": [lo, hi], "converged": convd / done,
                   "throughput_shots_per_s": done / dt if dt else 0.0,
                   "device_sampled": False}
        else:
            out = sdec.run_eval(shots, batch=batch, seed=seed, pipeline=pipeline,
                                max_seconds=max_seconds)
        if rounds and out.get("shots"):
            out["rounds"] = int(rounds)
            out["per_round_rate"] = 1.0 - (
                1.0 - out["logical_rate"]) ** (1.0 / rounds)
        return out

    if isinstance(dem, DetectorGraphDecoder):
        dec = dem
    elif isinstance(dem, tuple):
        A, priors, O = dem
        dec = DetectorGraphDecoder(A, priors, max_iters, observables=O,
                                   decoder=decoder, device=device, **knobs)
    else:
        dec = DetectorGraphDecoder.from_dem(dem, max_iters, decoder=decoder,
                                            device=device, **knobs)
    if dec.O is None or dec.O.shape[0] == 0:
        raise ValueError("the model declares no logical observables")

    dense_ok = dec.D * dec.N <= _DEVICE_SWEEP_MAX_DENSE
    use_dev = (circuit is None and dense_ok) if on_device is None else bool(on_device)
    if circuit is not None and use_dev:
        raise ValueError("circuit sampling is host-side; pass "
                         "on_device=False or drop it")

    if use_dev:
        AdT = _dense_f32(dec.A, dec.device).T
        OdT = _dense_f32(dec.O, dec.device).T
        prior = torch.as_tensor(dec._prior, dtype=torch.float32, device=dec.device)

        def dev_step(b, noise_seed, decode_seed):
            x = draw_mechanisms(prior, b, noise_seed)
            det = torch.remainder(x @ AdT, 2.0).to(torch.uint8)
            x_hat, conv, _, _ = dec.batch_decode_detailed_async(det, seed=decode_seed)
            diff = (x + x_hat.to(torch.float32)) @ OdT
            fail = (torch.remainder(diff, 2.0) != 0).any(dim=1)
            return torch.stack([fail.sum(), conv.sum()])
    else:
        A_dense = np.asarray(dec.A.todense())  # hoisted: host batches reuse it
    circ_det = circ_obs = None
    if circuit is not None:
        from .codes.circuit import sample_circuit

        circ_det, circ_obs = sample_circuit(circuit, shots, seed=seed)

    trials = fails = convd = 0
    inflight: list = []
    inflight_trials = 0
    step_i = 0
    depth = max(1, int(pipeline)) if use_dev else 1
    stopping = False
    t0 = time.perf_counter()

    def finalize_one():
        nonlocal trials, fails, convd, inflight_trials
        item, b = inflight.pop(0)
        f, c = _host_ints(item) if isinstance(item, torch.Tensor) else item
        fails += int(f)
        convd += int(c)
        trials += b
        inflight_trials -= b

    while trials + inflight_trials < shots or inflight:
        if max_seconds is not None and not stopping and (
                time.perf_counter() - t0) >= max_seconds:
            stopping = True
        if stopping and not inflight:
            break
        want_more = not stopping and trials + inflight_trials < shots
        if not want_more or len(inflight) >= depth:
            finalize_one()
            continue
        b = min(batch, shots - trials - inflight_trials)
        rng = np.random.default_rng((seed, step_i))
        decode_seed = int(rng.integers(1 << 31))
        if use_dev:
            noise_seed = int(rng.integers(1 << 31))
            item = dev_step(b, noise_seed, decode_seed)
        else:
            lo = trials + inflight_trials
            if circuit is not None:
                det = circ_det[lo: lo + b]
                obs = circ_obs[lo: lo + b]
            else:
                x = (rng.random((b, dec.N)) < dec._prior).astype(np.uint8)
                det = (x @ A_dense.T) & 1
                obs = (x @ dec.O.T) & 1
            pred, conv = dec.predict_observables(det, seed=decode_seed)
            item = (int((pred != obs).any(axis=1).sum()),
                    int(np.asarray(conv).sum()))
        inflight.append((item, b))
        inflight_trials += b
        step_i += 1
    dt = time.perf_counter() - t0
    if not trials:
        return {"shots": 0}
    lo, hi = wilson_interval(fails, trials)
    out = {
        "shots": trials,
        "fails": fails,
        "logical_rate": fails / trials,
        "logical_ci95": [lo, hi],
        "converged": convd / trials,
        "throughput_shots_per_s": trials / dt if dt else 0.0,
        "device_sampled": bool(use_dev),
    }
    if rounds:
        out["rounds"] = int(rounds)
        out["per_round_rate"] = 1.0 - (1.0 - out["logical_rate"]) ** (
            1.0 / rounds)
    return out
