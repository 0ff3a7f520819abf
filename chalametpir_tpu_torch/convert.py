"""Carry serving state from the JAX package into the port.

The packed planes are the same bytes in both packages, so a JAX server's
state moves over as numpy arrays: from a live `chalametpir_tpu.Server`
with the packed layout, or from the archive its `save` writes.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.server import Server, resolve_device
from .ops.respond_packed import PackedPlanes


def planes_from_numpy(lo, hi, b: int, num_rows: int, num_cols: int, device) -> PackedPlanes:
    """Packed planes from host arrays: lo (m_pad, c_pad) int8, hi
    (m_pad, pc) uint8 or None."""
    device = resolve_device(device)
    # copies: the source may be a read-only view of another framework's buffer
    lo_t = torch.from_numpy(np.array(lo, np.int8)).to(device)
    hi_t = None if hi is None else torch.from_numpy(np.array(hi, np.uint8)).to(device)
    return PackedPlanes(lo_t, hi_t, b, num_rows, num_cols)


def _server(planes: PackedPlanes) -> Server:
    return Server("torch", planes, planes.num_rows, planes.num_cols, planes.mat_elem_bit_len, "packed")


def server_from_jax(server, device) -> Server:
    """Port server serving the planes of a packed-layout JAX server."""
    if getattr(server, "_layout", None) != "packed" or getattr(server, "_mesh", None) is not None:
        raise NotImplementedError("only an unsharded packed-layout server converts")
    pdb = server._planes
    return _server(planes_from_numpy(
        np.asarray(pdb.lo), None if pdb.hi is None else np.asarray(pdb.hi),
        pdb.mat_elem_bit_len, pdb.num_rows, pdb.num_cols, device,
    ))


def server_from_jax_archive(path: str, device) -> Server:
    """Port server from an archive written by chalametpir_tpu.Server.save
    (any of its layouts): `Server.load` reads them all."""
    return Server.load(path, device)
