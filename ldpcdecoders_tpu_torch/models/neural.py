"""Neural (trainable) min-sum decoding: learned check-update scaling.

Counterpart of ``ldpcdecoders_tpu/models/neural.py``.  One
``(alpha_t, beta_t)`` pair per iteration (Lugosch & Gross's offset network,
extended with the normalization term), and with ``param_scope="edge"`` also
per-edge variable-update weights ``w [T, max_dv, n]`` (Nachmani et al.),
are fitted by gradient descent through the unrolled decoder.

  * :class:`SoftMinSum` is the differentiable forward of the reference's
    ``make_soft_minsum_fn``: fixed ``T`` iterations, no early exit, the
    soft LLRs of every iteration ``[T, B, n]``, in plain torch.  Autograd
    differentiates it; the check update is written as the reference's
    unrolled two-minimum sweep with ``torch.where`` / ``torch.minimum`` /
    ``torch.maximum``, whose gradients at ties split as JAX's do.
  * :meth:`NeuralMinSumDecoder.train` replaces ``jax.value_and_grad`` and
    optax with autograd and ``torch.optim.Adam`` (optax's ``adam``
    defaults): the ``learn`` freezing (a frozen parameter's gradient is
    zeroed), the clips after each step, the per-iteration sigmoid BCE
    (``F.binary_cross_entropy_with_logits``, the same function as optax's
    ``sigmoid_binary_cross_entropy``), and fresh channel draws from a
    ``torch.Generator(seed)`` on the decoder's device (not the reference's
    ``jax.random`` bits).  No kernel is differentiated.
  * Decoding runs the trained schedule through ``MinSumDecode`` with
    per-iteration arrays and edge weights (the variable layout), which on
    a card is the K3/K4 kernels.
  * :meth:`save_schedule` / :meth:`load_schedule` write and read the
    reference's npz: a schedule trained in either package decodes in the
    other.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..codes.graph import TannerGraph
from ..ops.syndrome import SyndromeCheck
from .base import Decoder, resolve_device
from .minsum import MinSumDecode
from .peeling import graph_of
from .priors import per_to_llr

__all__ = ["NeuralMinSumDecoder", "SoftMinSum", "soft_minsum_loss", "make_soft_minsum_fn"]

_BIG = 1e30


class SoftMinSum(torch.nn.Module):
    """``forward(params, syndromes [B, m], L0) -> llrs [T, B, n]`` where
    ``params = {"alpha": [T], "beta": [T]}`` plus optionally ``"w": [T,
    max_dv, n]``: the training-time unrolled min-sum (the reference's
    ``make_soft_minsum_fn``), differentiable in ``params``."""

    def __init__(self, graph: TannerGraph, max_iters: int, *, device, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.m, self.n = graph.m, graph.n
        self.max_dc, self.max_dv = graph.max_dc, graph.max_dv
        self.max_iters = int(max_iters)
        self.dtype = dtype
        c2v_t, v2c_t, chk_mask_t, var_mask_t = graph.slot_major()
        self.register_buffer("c2v", torch.as_tensor(c2v_t.astype(np.int64), device=device))
        self.register_buffer("v2c", torch.as_tensor(v2c_t.astype(np.int64), device=device))
        self.register_buffer("chk_mask", torch.as_tensor(chk_mask_t, device=device))
        self.register_buffer("var_mask", torch.as_tensor(var_mask_t, device=device))

    def check_update(self, nu, syn_flip, alpha, beta):
        B, m, dc = nu.shape[0], self.m, self.max_dc
        big = torch.tensor(_BIG, dtype=nu.dtype, device=nu.device)
        zero = torch.zeros((), dtype=nu.dtype, device=nu.device)
        Ng = nu.reshape(B, self.max_dv * self.n).index_select(1, self.c2v).reshape(B, dc, m)
        masked = torch.where(self.chk_mask, Ng, big)
        mag = masked.abs()
        neg = masked < 0
        # the reference's unrolled two-minimum sweep, for its gradients
        min1 = mag[:, 0:1]
        idx1 = torch.zeros_like(min1, dtype=torch.int64)
        min2 = big.expand_as(min1)
        parity = neg[:, 0:1]
        for k in range(1, dc):
            v = mag[:, k:k + 1]
            smaller = v < min1
            min2 = torch.where(smaller, min1, torch.minimum(min2, v))
            idx1 = torch.where(smaller, k, idx1)
            min1 = torch.where(smaller, v, min1)
            parity = parity ^ neg[:, k:k + 1]
        syn = syn_flip[:, None, :]
        outs = []
        for k in range(dc):
            excl = torch.where(idx1 == k, min2, min1)
            flip = parity ^ neg[:, k:k + 1] ^ syn
            mag_out = torch.maximum(alpha * excl - beta, zero)
            outs.append(torch.where(flip, -mag_out, mag_out))
        return torch.cat(outs, dim=1)

    def forward(self, params: dict, syndromes: torch.Tensor, L0) -> torch.Tensor:
        if L0 is None:
            raise ValueError("pass the channel LLR L0 explicitly")
        B, n, dtype, device = syndromes.shape[0], self.n, self.dtype, syndromes.device
        L0 = torch.broadcast_to(torch.as_tensor(L0, device=device).to(dtype), (B, n))
        syn_flip = syndromes.to(torch.bool)
        nu = torch.broadcast_to(L0[:, None, :], (B, self.max_dv, n))
        alpha, beta = params["alpha"].to(dtype), params["beta"].to(dtype)
        w = params.get("w")
        zero = torch.zeros((), dtype=dtype, device=device)
        llrs = []
        for t in range(alpha.shape[0]):
            mu = self.check_update(nu, syn_flip, alpha[t], beta[t])
            Mg = mu.reshape(B, self.max_dc * self.m).index_select(1, self.v2c)
            Mg = torch.where(self.var_mask, Mg.reshape(B, self.max_dv, n), zero)
            if w is not None:
                Mg = Mg * w[t].to(dtype)[None]
            acc = Mg[:, 0]
            for k in range(1, self.max_dv):
                acc = acc + Mg[:, k]
            total = L0 + acc
            nu = total[:, None, :] - Mg
            llrs.append(total)
        return torch.stack(llrs)  # [T, B, n]


def make_soft_minsum_fn(graph: TannerGraph, max_iters: int, *, device=None,
                        dtype=torch.float32) -> SoftMinSum:
    """The differentiable forward (reference ``make_soft_minsum_fn``)."""
    return SoftMinSum(graph, max_iters, device=device, dtype=dtype)


def soft_minsum_loss(soft: SoftMinSum, params: dict, syndromes, errors, L0) -> torch.Tensor:
    """The training objective: the mean over iterations, lanes and bits of
    the sigmoid binary cross-entropy of ``P(e = 1) = sigmoid(-llr)``
    against the injected errors (optax's ``sigmoid_binary_cross_entropy``
    with logits ``-llr``)."""
    llrs = soft(params, syndromes, L0)
    return F.binary_cross_entropy_with_logits(-llrs, errors.to(llrs.dtype).expand_as(llrs))


class NeuralMinSumDecoder(Decoder):
    """Min-sum decoder with learned per-iteration normalization/offset.

    Construct, :meth:`train`, then decode: the trained schedule is baked
    into a standard decode (early exit, per-lane masks), at the cost of a
    :class:`~.minsum.MinSumDecoder`.

    Args:
      H: parity-check matrix (dense, scipy.sparse, or ``TannerGraph``).
      per: physical error rate (training draws at this rate unless
        ``train(per=...)`` overrides it).
      max_iters: decode iterations == number of trained (alpha, beta) pairs.
      learn: ``"both"`` (default), ``"alpha"`` or ``"beta"``: which
        schedule parameters receive gradients.
      param_scope: ``"iteration"`` (default, 2T scalars) or ``"edge"``
        (adds per-edge variable-update weights, ``T * max_dv * n``).
      dtype: message dtype.
      device: where training and decoding run; None is the current CUDA card.
    """

    def __init__(self, H, per: float, max_iters: int, *, learn: str = "both",
                 param_scope: str = "iteration", dtype=torch.float32, device=None):
        super().__init__()
        if learn not in ("both", "alpha", "beta"):
            raise ValueError(f"learn must be 'both', 'alpha', or 'beta', got {learn!r}")
        if param_scope not in ("iteration", "edge"):
            raise ValueError(f"param_scope must be 'iteration' or 'edge', got {param_scope!r}")
        self.device = resolve_device(device)
        self.graph = graph_of(H)
        self.m, self.n = self.graph.m, self.graph.n
        self.per = float(per)
        self.max_iters = int(max_iters)
        self.learn = learn
        self.param_scope = param_scope
        self.dtype = dtype
        self.alpha = np.ones(self.max_iters, np.float32)
        self.beta = np.zeros(self.max_iters, np.float32)
        self.w = (np.ones((self.max_iters, self.graph.max_dv, self.n), np.float32)
                  if param_scope == "edge" else None)
        self.soft = SoftMinSum(self.graph, self.max_iters, device=self.device, dtype=dtype)
        self.syndrome_from = SyndromeCheck(self.graph, self.device)
        self._rebuild()

    def _rebuild(self):
        self.minsum = MinSumDecode(self.graph, self.per, self.max_iters, device=self.device,
                                   alpha=self.alpha, beta=self.beta, dtype=self.dtype,
                                   edge_weights=self.w)

    def _params(self) -> dict:
        """The schedule as float32 tensors on the device (``alpha``, ``beta``
        and, with ``param_scope="edge"``, ``w``)."""
        p = {"alpha": torch.as_tensor(self.alpha, device=self.device),
             "beta": torch.as_tensor(self.beta, device=self.device)}
        if self.w is not None:
            p["w"] = torch.as_tensor(self.w, device=self.device)
        return {k: v.clone() for k, v in p.items()}

    def train(self, mode: bool | None = None, *, steps: int = 300, batch: int = 256,
              lr: float = 2e-2, seed: int = 0, per: float | None = None,
              per_range: tuple[float, float] | None = None):
        """Fit the schedule by Adam on fresh channel samples.

        ``train(mode)`` with a bool is ``nn.Module.train``: it sets the
        module's mode (``eval()`` and a parent module's ``train``/``eval``
        call it so) and returns the module.  Called without ``mode`` it trains.

        Each step draws ``batch`` iid error patterns at ``per`` on the
        device, unrolls :class:`SoftMinSum` and minimizes the mean
        per-iteration sigmoid cross-entropy between its LLRs and the
        injected errors.  ``per_range=(lo, hi)`` trains a robust schedule:
        each lane draws its own rate uniformly from the range (and the
        matching channel LLR).  Returns ``{"losses": [steps]}`` and bakes
        the trained schedule into the decode.
        """
        if mode is not None:
            return super().train(mode)
        n, device = self.n, self.device
        if per_range is not None:
            lo, hi = (float(x) for x in per_range)
            if not 0.0 < lo <= hi < 0.5:
                raise ValueError(f"per_range must satisfy 0 < lo <= hi < 0.5, got {per_range}")
        else:
            per_t = self.per if per is None else float(per)
            L0_const = float(per_to_llr(per_t, 1))
        params = self._params()
        for v in params.values():
            v.requires_grad_(True)
        opt = torch.optim.Adam(list(params.values()), lr=lr)
        frozen = {"both": (), "alpha": ("beta",), "beta": ("alpha",)}[self.learn]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        losses = []
        for _ in range(int(steps)):
            if per_range is not None:
                p_lane = lo + (hi - lo) * torch.rand((batch, 1), generator=gen, device=device)
                e = (torch.rand((batch, n), generator=gen, device=device) < p_lane).float()
                L0 = torch.log((1.0 - p_lane) / p_lane) * torch.ones((1, n), device=device)
            else:
                e = (torch.rand((batch, n), generator=gen, device=device) < per_t).float()
                L0 = L0_const
            syn = self.syndrome_from(e)
            loss = soft_minsum_loss(self.soft, params, syn, e, L0)
            opt.zero_grad()
            loss.backward()
            for name in frozen:
                params[name].grad.zero_()
            opt.step()
            with torch.no_grad():
                # the numerically sane region: alpha > 0, beta >= 0
                params["alpha"].clamp_(1e-2, 2.0)
                params["beta"].clamp_(0.0, 5.0)
                if "w" in params:
                    params["w"].clamp_(0.0, 2.0)
            losses.append(float(loss.detach()))
        self.alpha = params["alpha"].detach().cpu().numpy().astype(np.float32)
        self.beta = params["beta"].detach().cpu().numpy().astype(np.float32)
        if "w" in params:
            self.w = params["w"].detach().cpu().numpy().astype(np.float32)
        self._rebuild()
        return {"losses": losses}

    def save_schedule(self, path: str) -> None:
        """Write the schedule to npz (the reference's keys)."""
        extra = {"w": self.w} if self.w is not None else {}
        np.savez(path, alpha=self.alpha, beta=self.beta, max_iters=np.int64(self.max_iters),
                 m=np.int64(self.m), n=np.int64(self.n), **extra)

    def load_schedule(self, path: str) -> "NeuralMinSumDecoder":
        """Load a schedule saved by either package's ``save_schedule``
        (shapes validated against the code and iteration count)."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as d:
            if (int(d["max_iters"]), int(d["m"]), int(d["n"])) != (
                    self.max_iters, self.m, self.n):
                raise ValueError(
                    f"schedule was trained for max_iters={int(d['max_iters'])} on an "
                    f"[{int(d['m'])}, {int(d['n'])}] code; this decoder is "
                    f"max_iters={self.max_iters} on [{self.m}, {self.n}]")
            self.alpha = np.asarray(d["alpha"], np.float32)
            self.beta = np.asarray(d["beta"], np.float32)
            if "w" in d.files:
                self.w = np.asarray(d["w"], np.float32)
            elif self.w is not None:
                raise ValueError("schedule has no per-edge weights but this decoder was "
                                 "built with param_scope='edge'")
        self._rebuild()
        return self

    def _decode_batch(self, syndromes, seed: int = 0, per=None):
        L0 = None if per is None else self.minsum.as_prior(per)
        err, converged, iters, llrs = self.minsum(syndromes, L0)
        return err, converged, iters, {"llrs": llrs}
