"""The inputs of a cell: its code, its channel and its pool of syndromes.

A configuration's ``code`` is a detector error model read from a data file
under ``data/`` (``"kind": "dem"``, its sha256 checked on load) or a
Gallager code built from its parameters (``"kind": "gallager"``, the
construction of the reference package: a block of ``n / wr`` rows of ``wr``
consecutive ones stacked with ``wc - 1`` column-shuffled copies, the shuffles
from ``np.random.default_rng(rng)``).

A traffic mix's ``channel`` gives each column of the code its probability of
being set: ``{"per": p}`` for every column alike, or ``{"priors": {"file":
..., "sha256": ...}}`` for a detector error model's own priors (the file
holds the same matrix as the configuration's).  The one generator draws
``x ~ Bernoulli(priors)`` on the device from a ``torch.Generator`` seeded with
the run's seed and hands the decoder the syndromes ``M x mod 2`` as numpy
``uint8``, one ``[batch, m]`` array a call.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["Code", "Channel", "load_code", "load_channel", "draw_pool", "gallager_pcm"]


@dataclasses.dataclass
class Code:
    kind: str
    M: sp.csr_matrix  # [m, n] uint8
    O: np.ndarray | None  # [k, n] observables of a detector error model

    @property
    def m(self) -> int:
        return self.M.shape[0]

    @property
    def n(self) -> int:
        return self.M.shape[1]

    @property
    def edges(self) -> int:
        return int(self.M.nnz)


@dataclasses.dataclass
class Channel:
    priors: np.ndarray  # [n] float64
    arg: object  # what the decoder is built with: the scalar per or the priors


def _data(bench_dir: Path, ref: dict) -> np.lib.npyio.NpzFile:
    path = bench_dir / ref["file"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != ref["sha256"]:
        raise ValueError(f"{path}: sha256 {digest}, expected {ref['sha256']}")
    return np.load(path, allow_pickle=False)


def gallager_pcm(n: int, wr: int, wc: int, rng: int) -> np.ndarray:
    """A (wr, wc)-regular Gallager parity-check matrix ``[n * wc / wr, n]``."""
    if n % wr:
        raise ValueError(f"n ({n}) must be divisible by wr ({wr})")
    gen = np.random.default_rng(rng)
    rows = n * wc // wr
    block = np.kron(np.eye(rows // wc, dtype=np.uint8), np.ones((1, wr), dtype=np.uint8))
    return np.concatenate([block] + [block[:, gen.permutation(n)] for _ in range(wc - 1)])


def _dem_matrix(z) -> sp.csr_matrix:
    return sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                         shape=tuple(int(s) for s in z["shape"])).astype(np.uint8)


def load_code(conf: dict, bench_dir: Path) -> Code:
    c = conf["code"]
    if c["kind"] == "dem":
        z = _data(bench_dir, c)
        return Code("dem", _dem_matrix(z), np.asarray(z["obs"], np.uint8))
    if c["kind"] == "gallager":
        H = gallager_pcm(int(c["n"]), int(c["wr"]), int(c["wc"]), int(c["rng"]))
        return Code("gallager", sp.csr_matrix(H), None)
    raise ValueError(f"unknown code kind {c['kind']!r}")


def load_channel(traffic: dict, code: Code, bench_dir: Path) -> Channel:
    ch = traffic["channel"]
    if "per" in ch:
        per = float(ch["per"])
        return Channel(np.full(code.n, per), per)
    z = _data(bench_dir, ch["priors"])
    if (_dem_matrix(z) != code.M).nnz:
        raise ValueError(f"{ch['priors']['file']} holds another matrix than the configuration")
    priors = np.asarray(z["priors"], np.float64)
    return Channel(priors, priors)


def draw_pool(code: Code, channel: Channel, batch: int, batches: int, seed: int,
              device) -> list[np.ndarray]:
    """``batches`` arrays ``[batch, m]`` uint8 of syndromes ``M x mod 2`` with
    ``x ~ Bernoulli(priors)``, drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    Mt = torch.as_tensor(code.M.T.toarray(), dtype=torch.float32, device=device)
    prior = torch.as_tensor(channel.priors, dtype=torch.float32, device=device)
    pool = []
    for _ in range(batches):
        x = (torch.rand((batch, code.n), generator=gen, device=device) < prior).to(torch.float32)
        # float32 sums of 0/1 (at most a row's weight): exact
        syn = torch.remainder(x @ Mt, 2.0).to(torch.uint8)
        pool.append(syn.cpu().numpy())
    return pool
