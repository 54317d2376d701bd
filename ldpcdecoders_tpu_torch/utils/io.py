"""Binary (npz) persistence for codes and sweep checkpoints.

Counterpart of ``ldpcdecoders_tpu/utils/io.py``, carried unchanged: the
same npz layouts and the same JSON, so a file written by either package
loads in the other (the FER sweep's checkpoints among them).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

__all__ = [
    "save_code_npz",
    "load_code_npz",
    "save_graph_npz",
    "load_graph_npz",
    "atomic_write_json",
    "read_json",
]


def _npz(path: str) -> str:
    """np.savez appends '.npz' when missing; normalize so save/load agree."""
    return path if path.endswith(".npz") else path + ".npz"


def save_code_npz(path: str, H: np.ndarray, **metadata) -> None:
    """Save a parity-check matrix (and optional metadata arrays) to npz."""
    np.savez_compressed(_npz(path), H=np.asarray(H, dtype=np.uint8), **metadata)


def load_code_npz(path: str):
    """Load a parity-check matrix saved by :func:`save_code_npz`.

    Returns ``(H, metadata_dict)``.
    """
    with np.load(_npz(path)) as data:
        H = data["H"]
        meta = {k: data[k] for k in data.files if k != "H"}
    return H, meta


def save_graph_npz(path: str, graph) -> None:
    """Persist a compiled TannerGraph (works for dense-free graphs)."""
    arrays = dict(
        chk_vars=graph.chk_vars,
        chk_mask=graph.chk_mask,
        var_chks=graph.var_chks,
        var_mask=graph.var_mask,
        c2v_gather=graph.c2v_gather,
        v2c_gather=graph.v2c_gather,
        dims=np.array([graph.m, graph.n, graph.max_dc, graph.max_dv, graph.n_edges]),
    )
    if graph.H is not None:
        arrays["H"] = graph.H
    np.savez_compressed(_npz(path), **arrays)


def load_graph_npz(path: str):
    """Load a TannerGraph saved by :func:`save_graph_npz`."""
    from ..codes.graph import TannerGraph

    with np.load(_npz(path)) as d:
        m, n, max_dc, max_dv, n_edges = (int(x) for x in d["dims"])
        return TannerGraph(
            m=m,
            n=n,
            max_dc=max_dc,
            max_dv=max_dv,
            n_edges=n_edges,
            H=d["H"] if "H" in d.files else None,
            chk_vars=d["chk_vars"],
            chk_mask=d["chk_mask"],
            var_chks=d["var_chks"],
            var_mask=d["var_mask"],
            c2v_gather=d["c2v_gather"],
            v2c_gather=d["v2c_gather"],
        )


def atomic_write_json(path: str, obj) -> None:
    """Crash-safe JSON write (tmp file + rename)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def read_json(path: str):
    with open(path) as f:
        return json.load(f)
