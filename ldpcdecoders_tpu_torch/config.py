"""Frozen decoder configurations.

Counterpart of ``ldpcdecoders_tpu/config.py``: the same dataclass, the same
fields and defaults, and the same JSON text, so a configuration serialized
by either package rebuilds in the other.  :meth:`DecoderConfig.build` makes
this package's decoder of every kind the reference builds.

Knobs of the reference that select TPU machinery have no effect here:
``use_pallas`` (the hand-written kernels always run on a card) and
``batch_tile`` (the QC kernel runs one lane per block).  ``backend`` of
``qc_minsum``: ``"auto"`` and ``"pallas"`` are the whole-decode CUDA
kernel, ``"xla"`` the lifted edge-list decoder.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

__all__ = ["DecoderConfig"]

_KINDS = (
    "bp",
    "bposd",
    "bitflip",
    "bpots",
    "minsum",
    "minsum_int8",
    "layered_minsum",
    "qc_minsum",
    "neural_minsum",
    # quantum wrapper kinds (SpaceTime / SlidingWindow / DetectorGraph)
    "spacetime",
    "window",
    "detector",
    "ensemble",
    "staged",
)

#: the kinds :meth:`DecoderConfig.build` makes in this package: all of them
PORTED_KINDS = _KINDS

#: decoder-specific knobs forwarded from a wrapper kind's config to its
#: inner decoder's DecoderConfig
_INNER_KNOBS = ("osd_order", "T", "C", "alpha", "beta", "scale", "beta_q",
                "use_pallas", "fused", "osd_scope", "osd_method",
                "osd_impl", "inner", "damping")

_QC_BACKENDS = {"auto": "cuda", "pallas": "cuda", "cuda": "cuda", "xla": "lifted",
                "lifted": "lifted"}


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Everything needed to build a decoder, minus the code itself.

    Example:
      >>> cfg = DecoderConfig(kind="bp", per=0.01, max_iters=50)
      >>> DecoderConfig.from_json(cfg.to_json()) == cfg
      True
    """

    kind: str
    per: float = 0.01
    max_iters: int = 100
    # decoder-specific knobs (ignored where not applicable)
    osd_order: int = 0
    T: int = 9
    C: float = 2.0
    # None = each decoder's own default (1.0 flooding, 0.8 layered)
    alpha: float | None = None
    beta: float = 0.0
    scale: float = 4.0
    beta_q: int = 1
    #: the reference's Pallas switch; no effect here
    use_pallas: bool | None = None
    #: BP+OSD only: one device program (not ported: raises)
    fused: bool = False
    #: BP+OSD only: "all" (reference semantics) or "failed" (OSD-w on
    #: failing lanes only)
    osd_scope: str = "all"
    #: BP+OSD only: "exhaustive" (reference 2^w sweep) or
    #: "combination_sweep" (OSD-CS: singles + pairs within osd_order)
    osd_method: str = "exhaustive"
    #: BP+OSD only: "device" (the elimination kernels) or "host" (the
    #: threaded C++ eliminator)
    osd_impl: str = "device"
    #: BP+OSD only: inner soft-output decoder — None/"sumproduct" or "minsum"
    inner: str | None = None
    #: minsum family: message damping in [0, 1)
    damping: float = 0.0
    #: qc_minsum only: 'auto' / 'pallas' (the whole-decode kernel) or 'xla'
    #: (the lifted edge-list decoder)
    backend: str = "auto"
    #: qc_minsum only: the reference's Pallas batch tile; no effect here
    batch_tile: int | None = None
    #: qc_minsum only: 'flooding' or 'layered' (serial-C over base rows)
    schedule: str = "flooding"
    #: qc_minsum only: 'minsum' or 'sumproduct' (exact tanh-rule BP)
    algorithm: str = "minsum"
    #: neural_minsum only (not ported)
    schedule_path: str | None = None
    #: spacetime/window/detector only: inner decoder kind
    inner_kind: str = "bposd"
    #: spacetime/window only: measurement rounds decoded jointly
    rounds: int = 1
    #: spacetime/window only: readout flip rate (None = per)
    meas_error_rate: float | None = None
    #: spacetime only: final round read out perfectly (closed problem)
    perfect_last: bool = True
    #: window only: rounds per decoded window / rounds committed per slide
    window: int = 3
    commit: int = 1
    #: detector only: flattened DEM file to build from (``build(None)``);
    #: alternatively pass ``build((A, priors[, observables]))``
    dem_path: str | None = None
    #: ensemble only: member configs (dicts or DecoderConfig instances,
    #: normalized to dicts so the whole thing JSON round-trips)
    members: tuple = ()
    #: staged only (models/staged.py): ensemble damping members — each a
    #: scalar or a [lo, hi] disordered-memory range; plus the stage-0
    #: iteration cap, relay restarts, and OSD-CS depths (lam pairs /
    #: lam3 triples).  max_iters is the deep (straggler) cap.
    gammas: tuple = (0.4,)
    stage0_iters: int = 96
    relay_legs: int = 0
    lam: int = 40
    lam3: int = 0
    #: staged only: deep-member message dtype, "f32" (default) or "bf16"
    deep_dtype: str | None = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown decoder kind '{self.kind}' (choose from {_KINDS})")
        # canonical form: JSON round-trips lists; gammas holds scalars
        # and/or (lo, hi) dmem ranges
        object.__setattr__(
            self, "gammas",
            tuple(tuple(float(x) for x in g)
                  if isinstance(g, (list, tuple)) else float(g)
                  for g in self.gammas))
        if (self.kind in ("spacetime", "window", "detector")
                and self.inner_kind in ("spacetime", "window", "detector")):
            raise ValueError(
                f"inner_kind '{self.inner_kind}' cannot itself be a wrapper "
                "kind; pick a base decoder (bp, bposd, minsum, ...)")
        if self.kind == "ensemble":
            if not self.members:
                raise ValueError("kind='ensemble' needs at least one member")
            norm = []
            for mcfg in self.members:
                d = (dataclasses.asdict(mcfg)
                     if isinstance(mcfg, DecoderConfig)
                     else dict(mcfg))
                if d.get("kind") in ("ensemble",):
                    raise ValueError("ensembles cannot nest ensembles")
                # a member's own (necessarily empty) members field would
                # round-trip tuple -> JSON list; drop it for canonical form
                if d.pop("members", None) not in (None, (), []):
                    raise ValueError("ensembles cannot nest ensembles")
                # validate AND canonicalize member fields (e.g. gammas
                # lists -> tuples) so dict equality survives JSON
                d = dataclasses.asdict(DecoderConfig.from_dict(d))
                d.pop("members", None)
                norm.append(d)
            object.__setattr__(self, "members", tuple(norm))
        elif self.members:
            raise ValueError("members is an ensemble-only field")
        else:
            # canonical empty form: JSON round-trips () as [], so pin ()
            object.__setattr__(self, "members", ())

    def build(self, H, *, device=None):
        """Construct the decoder for parity-check matrix ``H`` on
        ``device`` (None: the current CUDA card).

        For ``kind='qc_minsum'`` pass the code as ``(base, Z)``; for
        ``detector`` and ``staged`` as ``(A, priors[, observables])``.
        """
        from . import models

        k = self.kind
        if k == "ensemble":
            built = [DecoderConfig.from_dict(d).build(H, device=device)
                     for d in self.members]
            H_arr = H if (hasattr(H, "todense") or (
                hasattr(H, "ndim") and getattr(H, "ndim", 0) == 2)) else None
            return models.EnsembleDecoder(built, H=H_arr)
        if k in ("spacetime", "window", "detector"):
            knobs = {f: getattr(self, f) for f in _INNER_KNOBS}
            if k == "spacetime":
                return models.SpaceTimeDecoder(
                    H, self.rounds, self.per, self.max_iters,
                    meas_error_rate=self.meas_error_rate, decoder=self.inner_kind,
                    perfect_last=self.perfect_last, device=device, **knobs)
            if k == "window":
                return models.SlidingWindowDecoder(
                    H, self.per, self.max_iters, window=self.window, commit=self.commit,
                    meas_error_rate=self.meas_error_rate, decoder=self.inner_kind,
                    device=device, **knobs)
            if self.dem_path:
                return models.DetectorGraphDecoder.from_dem(
                    self.dem_path, self.max_iters, decoder=self.inner_kind, device=device,
                    **knobs)
            if not (isinstance(H, tuple) and len(H) in (2, 3)):
                raise ValueError(
                    "kind='detector' takes (A, priors) or (A, priors, "
                    "observables) as the code argument, or set dem_path")
            A, priors, *rest = H
            return models.DetectorGraphDecoder(
                A, priors, self.max_iters, observables=rest[0] if rest else None,
                decoder=self.inner_kind, device=device, **knobs)
        if k == "staged":
            import torch

            if not (isinstance(H, tuple) and len(H) in (2, 3)):
                raise ValueError(
                    "kind='staged' takes (A, priors) or (A, priors, "
                    "observables) as the code argument")
            A, priors, *rest = H
            gammas = tuple(tuple(g) if isinstance(g, (list, tuple)) else g
                           for g in self.gammas)
            deep_dtype = None
            if self.deep_dtype is not None:
                if self.deep_dtype not in ("f32", "bf16"):
                    raise ValueError(
                        f"deep_dtype must be 'f32' or 'bf16', got {self.deep_dtype!r}")
                deep_dtype = torch.bfloat16 if self.deep_dtype == "bf16" else torch.float32
            return models.StagedDemDecoder(
                A, priors, observables=rest[0] if rest else None,
                gammas=gammas, stage0_iters=self.stage0_iters,
                deep_iters=self.max_iters, lam=self.lam, lam3=self.lam3,
                relay_legs=self.relay_legs, deep_dtype=deep_dtype, device=device)
        if k == "qc_minsum":
            if not (isinstance(H, tuple) and len(H) == 2):
                raise ValueError(
                    "kind='qc_minsum' takes the code as a (base, Z) tuple, "
                    "not a lifted parity-check matrix")
            if self.backend not in _QC_BACKENDS:
                raise ValueError(
                    f"backend must be one of {sorted(_QC_BACKENDS)}, got {self.backend!r}")
            base, Z = H
            return models.QCMinSumDecoder(
                base, Z, self.per, self.max_iters, alpha=self.alpha, beta=self.beta,
                backend=_QC_BACKENDS[self.backend], schedule=self.schedule,
                algorithm=self.algorithm, device=device)
        if k == "bp":
            return models.BeliefPropagationDecoder(H, self.per, self.max_iters, device=device)
        if k == "bitflip":
            return models.BitFlipDecoder(H, self.per, self.max_iters, device=device)
        if k == "bpots":
            return models.BPOTSDecoder(H, self.per, self.max_iters, T=self.T, C=self.C,
                                       device=device)
        if k == "bposd":
            return models.BeliefPropagationOSDDecoder(
                H, self.per, self.max_iters, osd_order=self.osd_order,
                fused=self.fused, osd_scope=self.osd_scope,
                osd_method=self.osd_method, osd_impl=self.osd_impl,
                inner=self.inner, damping=self.damping, device=device)
        if k == "minsum_int8":
            return models.QuantizedMinSumDecoder(H, self.per, self.max_iters, scale=self.scale,
                                                 beta_q=self.beta_q, device=device)
        if k == "neural_minsum":
            dec = models.NeuralMinSumDecoder(H, self.per, self.max_iters, device=device)
            if self.schedule_path:
                dec.load_schedule(self.schedule_path)
            return dec
        if k == "layered_minsum":
            return models.LayeredMinSumDecoder(
                H, self.per, self.max_iters, damping=self.damping,
                alpha=0.8 if self.alpha is None else self.alpha, beta=self.beta, device=device)
        # k == "minsum"
        return models.MinSumDecoder(
            H, self.per, self.max_iters, damping=self.damping,
            alpha=1.0 if self.alpha is None else self.alpha, beta=self.beta, device=device)

    # -- serialization ----------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "DecoderConfig":
        return DecoderConfig(**json.loads(s))

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "DecoderConfig":
        return DecoderConfig(**d)
