"""Carry the state the JAX package derives and caches over to this package.

The erasure store has no weights; what the JAX package derives and keeps is
its coding state -- the parity matrix of a (k, m) geometry, its bit-expanded
GF(2) weights, the reconstruct rows of a loss pattern -- and, on every drive,
the ``format.json`` identity record. ``from_jax_layout`` takes those as the
JAX package holds them (numpy arrays; the JSON text or the parsed dict) and
returns this package's tensors and format objects, checking each against
what this package derives itself, so a layout mismatch raises instead of
coding with the wrong matrix.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .models.pipeline import resolve_device
from .ops import rs_matrix
from .storage.format import DriveFormat


def _u8(a, name: str) -> np.ndarray:
    arr = np.asarray(a)
    if arr.ndim != 2:
        raise ValueError(f"{name} must be 2-D, got shape {arr.shape}")
    return arr.astype(np.uint8)


def from_jax_layout(
    k: int,
    m: int,
    *,
    parity_matrix=None,
    parity_weights=None,
    present: tuple[bool, ...] | None = None,
    want: tuple[int, ...] | None = None,
    reconstruct_rows=None,
    format_json: "str | dict | None" = None,
    device="cuda",
) -> dict:
    """Convert JAX-package coding state for a (k, m) geometry.

    * ``parity_matrix``: [M, K] u8 (``rs_matrix.parity_matrix``) -> "parity",
      a [M, K] uint8 tensor.
    * ``parity_weights``: [K*8, M*8] {0,1} (``rs.parity_weights``) ->
      "parity_weights", a [K*8, M*8] int8 tensor in ops/rs.py's orientation.
    * ``reconstruct_rows`` with its ``present``/``want`` pattern:
      [len(want), K] u8 (``rs_matrix.reconstruct_rows``) -> "reconstruct",
      a uint8 tensor.
    * ``format_json``: a drive's format.json text (or the dict it parses to)
      -> "format", a DriveFormat.

    Each array must equal what this package derives for the same inputs.
    Tensors go to ``device``: "cuda" unless the caller asks for "cpu"; "cuda"
    without a card raises.
    """
    out: dict = {}
    if parity_matrix is not None:
        pm = _u8(parity_matrix, "parity_matrix")
        if not np.array_equal(pm, rs_matrix.parity_matrix(k, m)):
            raise ValueError(f"parity matrix does not match the ({k}, {m}) code")
        out["parity"] = torch.from_numpy(pm.copy()).to(resolve_device(device))
    if parity_weights is not None:
        w = np.asarray(parity_weights)
        want_w = rs_matrix.bit_expand(rs_matrix.parity_matrix(k, m))
        if w.shape != want_w.shape or not np.array_equal(w.astype(np.uint8), want_w):
            raise ValueError(f"parity weights do not match the ({k}, {m}) code's bit expansion")
        out["parity_weights"] = torch.from_numpy(w.astype(np.int8)).to(resolve_device(device))
    if reconstruct_rows is not None:
        if present is None or want is None:
            raise ValueError("reconstruct_rows needs its present mask and want rows")
        rr = _u8(reconstruct_rows, "reconstruct_rows")
        if not np.array_equal(rr, rs_matrix.reconstruct_rows(k, m, tuple(present), tuple(want))):
            raise ValueError("reconstruct rows do not match the loss pattern")
        out["reconstruct"] = torch.from_numpy(rr.copy()).to(resolve_device(device))
    if format_json is not None:
        raw = format_json if isinstance(format_json, str) else json.dumps(format_json)
        out["format"] = DriveFormat.from_json(raw)
    return out
