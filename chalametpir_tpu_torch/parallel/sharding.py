"""Sharded PIR serving over a (data, model) mesh of torch devices.

Counterpart of chalametpir_tpu/parallel/sharding.py: its packed functions,
which the sharded server runs, and its digit2 functions (`pad_db_planes`,
`shard_db_planes`, `sharded_respond_fn`, `sharded_hint_accumulate_fn`),
library functions in both packages: `Server.setup(mesh=...)` always packs.

* **model axis**: the fingerprint dimension m of the encoded DB is split
  in equal contiguous row shards (a DB too big for one device's memory).
  Each shard computes a partial (Q, c) int32 product over its rows and its
  slice of the query columns; the partials are summed. int32 addition
  wraps two's-complement, so the sum is exact mod 2^32.
* **data axis**: the rows of a query batch are split; each part rides its
  data row's shards.

The same mesh serves setup: A's row blocks (stream mode) are one batch of
queries with their columns split over `model`; in ctr mode each shard
generates only its own fingerprint range of A on its device.

torch has no single-process SPMD, so a `Mesh` comes in two kinds. An
in-process mesh is a grid of torch devices, which may repeat one device:
this process computes every shard and sums the partials itself. A
multi-process mesh is a torch.distributed process group in which rank r
holds shard s of data row d, (d, s) = divmod(r, model), on its own
device, and the partials are summed by all_reduce. Both kinds run the
same shard code: the respond kernel for planes on CUDA, its plain
version for planes on the CPU. A failing shard, rank or collective
raises; nothing falls back to an unsharded computation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..errors import AcceleratorError
from ..native import engine
from ..ops import prg_torch
from ..ops.digits import NUM_U32_DIGITS  # noqa: F401  (re-exported, as in the JAX package)
from ..ops.matmul_u32 import _matmul_digits, pad_plane
from ..ops.respond_packed import (
    LANE,
    M_ALIGN,
    PackedPlanes,
    hint_fold_partial,
    pack_geometry,
    respond_packed_core,
)
from ..ops.serving import ServingState
from ..params import LWE_DIMENSION


class Mesh:
    """A (data, model) layout of shards: `shape["data"]`, `shape["model"]`.

    In-process: `devices`, `data` rows of `model` torch devices. Multi-
    process: `group`, a process group of data x model ranks, and `device`,
    where this rank keeps its shard."""

    def __init__(self, data: int, model: int, devices=None, group=None, device=None):
        if (devices is None) == (group is None):
            raise ValueError("a mesh is a grid of devices or a process group")
        self.shape = {"data": data, "model": model}
        self.devices = devices
        self.group = group
        self.device = device

    def cells(self):
        """(d, s, device) of every shard this process computes: the whole
        grid in-process, this rank's own cell in a process group."""
        if self.group is None:
            for d, row in enumerate(self.devices):
                for s, device in enumerate(row):
                    yield d, s, device
        else:
            yield (*divmod(dist.get_rank(self.group), self.shape["model"]), self.device)


def mesh_shape(n: int, data: int | None, model: int | None) -> tuple[int, int]:
    """(data, model) over n devices or ranks: all on `model` by default, a
    missing axis by division; ValueError unless data x model == n."""
    if data is None and model is None:
        model = n
        data = 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return data, model


def make_mesh(devices=None, data: int | None = None, model: int | None = None) -> Mesh:
    """Build an in-process (data, model) mesh over `devices` (torch devices
    or their names; one device may appear several times), by default every
    visible CUDA device: AcceleratorError when there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise AcceleratorError("a mesh over the visible CUDA devices was requested but CUDA is not available")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_indexed(resolve_device(d)) for d in devices]
    data, model = mesh_shape(len(devices), data, model)
    return Mesh(data, model, devices=[devices[d * model : (d + 1) * model] for d in range(data)])


def _indexed(device: torch.device) -> torch.device:
    """"cuda" as the "cuda:i" a tensor placed there reports, so that one
    device has one name."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass
class ShardedPlanes(ServingState):
    """The packed DB, its rows split in `model` equal shards; the serving
    state over a mesh (ops/serving.py).

    `runs` maps each device of this process to (s0, lo, hi): the planes of
    the contiguous run of shards from s0 that the device holds, one tensor
    each, of which a shard is a row slice. A device that appears several
    times in the mesh gets its planes once; a rank of a process group
    holds its own shard alone."""

    mesh: Mesh
    runs: dict
    mat_elem_bit_len: int
    num_rows: int  # logical m
    num_cols: int  # logical c
    m_pad: int  # m rounded up to model x M_ALIGN

    @property
    def m_local(self) -> int:
        return self.m_pad // self.mesh.shape["model"]

    @property
    def c_pad(self) -> int:
        return next(iter(self.runs.values()))[1].shape[1]

    @property
    def device(self) -> torch.device:
        return next(iter(self.runs))

    @property
    def device_bytes(self) -> int:
        return sum(lo.numel() + (hi.numel() if hi is not None else 0) for _, lo, hi in self.runs.values())

    def shard(self, s: int, device: torch.device):
        """(lo, hi) of shard s on `device`: views of the device's run."""
        s0, lo, hi = self.runs[device]
        rows = slice((s - s0) * self.m_local, (s - s0 + 1) * self.m_local)
        return lo[rows], hi[rows] if hi is not None else None

    def columns(self, queries: torch.Tensor, device: torch.device) -> tuple[int, torch.Tensor]:
        """(s0, the query columns of the device's run of shards, on the
        device): one copy however many shards it holds."""
        s0, lo, _ = self.runs[device]
        return s0, queries[:, s0 * self.m_local : s0 * self.m_local + lo.shape[0]].to(device)

    def gather(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The whole (m_pad, ...) planes on the host. In-process only: a
        rank of a process group holds one shard."""
        if self.mesh.group is not None:
            raise ValueError("a rank of a multi-process mesh holds only its own shard")
        parts = [self.shard(s, device) for d, s, device in self.mesh.cells() if d == 0]
        lo = torch.cat([p[0].cpu() for p in parts])
        return lo, None if parts[0][1] is None else torch.cat([p[1].cpu() for p in parts])

    def respond(self, queries_u32: torch.Tensor) -> torch.Tensor:
        """Zero-padded to m_pad columns and a multiple of `data` rows (padded
        DB rows are zero too, so the padding adds nothing), the padded rows
        cut from the answer, which a gloo reduction leaves on the host."""
        nq, data = queries_u32.shape[0], self.mesh.shape["data"]
        shape = (-(-nq // data) * data, self.m_pad)
        if tuple(queries_u32.shape) != shape:
            padded = torch.zeros(shape, dtype=torch.int32, device=queries_u32.device)
            padded[:nq, : queries_u32.shape[1]] = queries_u32
            queries_u32 = padded
        return _sharded_product(self.mesh, self, queries_u32, split_rows=True)[:nq].to(self.device).contiguous()

    def archive(self) -> dict:
        """Of the gathered planes: it loads unsharded. ValueError on a rank."""
        return PackedPlanes(*self.gather(), self.mat_elem_bit_len, self.num_rows, self.num_cols).archive()


def build_sharded_pallas_db(mesh: Mesh, mat: np.ndarray, mat_elem_bit_len: int) -> ShardedPlanes:
    """Pack the encoded DB and place its planes row-sharded over `model`
    (shared by the data rows). The fingerprint dimension is padded to model
    x M_ALIGN rows, so that every shard holds whole tiles. The planes are
    packed whole on the host by the native engine's padded path, as the
    JAX package packs them for a mesh, so both packages build the same
    bytes: padded rows hold lo = -128, value zero (the ctr fold multiplies
    nonzero A against them); the padding columns of the other rows hold 0,
    in columns that no output reads."""
    model = mesh.shape["model"]
    m, c = mat.shape
    m_pad = -(-m // (model * M_ALIGN)) * model * M_ALIGN
    c_pad = -(-c // LANE) * LANE
    pack, bits, _ = pack_geometry(mat_elem_bit_len, c_pad)
    lo, hi = engine.build_packed_planes(mat, m_pad, c_pad, pack, bits)
    m_local = m_pad // model
    held: dict = {}
    for _, s, device in mesh.cells():
        held.setdefault(device, []).append(s)
    runs = {}
    for device, shards in held.items():
        rows = slice(min(shards) * m_local, (max(shards) + 1) * m_local)
        runs[device] = (
            min(shards),
            torch.from_numpy(lo[rows]).to(device),
            torch.from_numpy(hi[rows]).to(device) if hi is not None else None,
        )
    return ShardedPlanes(mesh, runs, mat_elem_bit_len, m, c, m_pad)


def _sum_partials(mesh: Mesh, partials: dict) -> torch.Tensor:
    """The reduction of the mesh: the sum mod 2^32 of one int32 partial per
    device (in-process, moved to the first device; `+` on int32 wraps) or
    per rank (all_reduce SUM, which wraps too). A gloo group reduces host
    tensors, so there the partial is staged through the host and the sum
    stays there; only an NCCL group reduces on the device."""
    if mesh.group is None:
        total, *rest = partials.values()
        for part in rest:
            total += part.to(total.device)
        return total
    (part,) = partials.values()
    if dist.get_backend(mesh.group) != "nccl":
        part = part.cpu()
    dist.all_reduce(part, op=dist.ReduceOp.SUM, group=mesh.group)
    return part


def _over_cells(mesh: Mesh, nq: int, width: int, split_rows: bool, add_partial) -> torch.Tensor:
    """The (nq, width) int32 sum over the mesh of the shards' partials.
    `add_partial(s, device, rows, out)` adds shard s's partial for the query
    rows `rows` (a slice) into `out`, the device's zeroed buffer of the
    whole answer. With `split_rows` data row d answers rows [d nq/data,
    (d + 1) nq/data); without, data row 0 answers them all (A's row
    blocks: every data row would compute the same). The buffers are summed
    over the mesh: everything is linear in the DB rows, so the sum of the
    shards' int32 partials is exact mod 2^32."""
    data = mesh.shape["data"]
    if split_rows and nq % data:
        raise ValueError(f"{nq} query rows do not split over {data} data rows")
    rows = nq // data if split_rows else nq
    partials: dict = {}
    for d, s, device in mesh.cells():
        if device not in partials:
            partials[device] = torch.zeros((nq, width), dtype=torch.int32, device=device)
        if d and not split_rows:
            continue
        r0 = d * rows if split_rows else 0
        add_partial(s, device, slice(r0, r0 + rows), partials[device])
    return _sum_partials(mesh, partials)


def _sharded_product(mesh: Mesh, db: ShardedPlanes, queries: torch.Tensor, split_rows: bool) -> torch.Tensor:
    """(Q, m_pad) int32 u32-bit queries -> (Q, c) int32 over the sharded
    packed planes (`_over_cells`); each device takes its run's query
    columns in one copy."""
    if queries.shape[1] != db.m_pad:
        raise ValueError(f"query length {queries.shape[1]} != padded DB rows {db.m_pad}")
    columns: dict = {}

    def add_partial(s, device, rows, out):
        if device not in columns:
            columns[device] = db.columns(queries, device)
        s0, q_run = columns[device]
        cols = slice((s - s0) * db.m_local, (s - s0 + 1) * db.m_local)
        # the local partial (the JAX package's `_packed_partial_i32`): the
        # respond kernel for planes on CUDA, its plain version for planes on
        # the CPU, added into the device's buffer
        respond_packed_core(q_run[rows, cols], *db.shard(s, device), db.mat_elem_bit_len,
                            db.num_cols, out=out[rows])

    return _over_cells(mesh, queries.shape[0], db.c_pad, split_rows, add_partial)[:, : db.num_cols]


def sharded_respond_packed_fn(mesh: Mesh, db: ShardedPlanes):
    """(Q, m_pad) int32 queries -> (Q, c) int32 over the packed planes:
    query rows split over `data` (Q a multiple of it), columns over
    `model`, the int32 partials summed exactly. The result lies on the
    mesh's first device, or on the host after a gloo reduction.

    Callers pad queries with zeros to db.m_pad columns: padded DB rows are
    zero too, so the tail adds nothing."""
    return lambda queries: _sharded_product(mesh, db, queries, split_rows=True)


def sharded_hint_packed_fn(mesh: Mesh, db: ShardedPlanes):
    """The hint step over the packed planes: a block of A's rows is a batch
    of queries, the same for every data row, columns split over `model`."""
    return lambda a_block: _sharded_product(mesh, db, a_block, split_rows=False)


def _sharded_chunk_rows(m_local: int, tile_k: int) -> int:
    """Rows per hint-fold chunk on one shard: a multiple of tile_k that
    divides m_local exactly (the fold slices fixed windows at j * cc: an
    overhang would re-read rows), targeting at most 2^17 rows. m_local =
    t * tile_k by construction (build_sharded_pallas_db aligns m_pad to
    model * tile_k); the largest divisor of t within the target is chosen.
    The JAX package's rule, so both cut the same chunks."""
    if m_local % tile_k != 0:
        raise AssertionError(f"sharded planes misaligned: m_local={m_local} tile_k={tile_k}")
    t = m_local // tile_k
    max_tiles = max(1, (1 << 17) // tile_k)
    for cand in range(min(t, max_tiles), 0, -1):
        if t % cand == 0:
            return cand * tile_k
    return tile_k


def sharded_hint_ctr_packed(mesh: Mesh, db: ShardedPlanes, seed: bytes) -> np.ndarray:
    """Full (LWE_DIMENSION, c) uint32 hint over the mesh, ctr PRG mode.

    ctr A is fingerprint-major, so each shard's fingerprint range of A is
    one contiguous ctr word range: every shard generates exactly its own
    slice on its device with the ctr Keccak kernel (never the full A, so
    A memory per device is bounded by a chunk) and folds it chunk by chunk
    against its rows, padded rows included (A is nonzero there, D is
    zero). Chunk j of shard s starts at fingerprint column s * m_local +
    j * cc, a word offset that `prg_torch.fp_block_start` turns into a ctr
    block and an offset in exact Python integers. Data row 0 folds; the
    devices' partial hints are summed over the mesh once at the end."""
    cc = _sharded_chunk_rows(db.m_local, M_ALIGN)
    seed_words = prg_torch.seed_to_words(seed)
    partials: dict = {}
    for d, s, device in mesh.cells():
        if device not in partials:
            partials[device] = torch.zeros((LWE_DIMENSION, db.c_pad), dtype=torch.int32, device=device)
        if d:
            continue
        lo, hi = db.shard(s, device)
        for r0 in range(0, db.m_local, cc):
            slab = prg_torch.expand_fp_slab(seed_words, s * db.m_local + r0, cc, LWE_DIMENSION, device)
            hint_fold_partial(slab.t(), lo[r0 : r0 + cc], hi[r0 : r0 + cc] if hi is not None else None,
                              db.mat_elem_bit_len, db.num_cols, out=partials[device])
    hint = _sum_partials(mesh, partials)[:, : db.num_cols]
    return hint.cpu().contiguous().numpy().view(np.uint32)


# -- the digit2 layout over a mesh -------------------------------------------


def pad_db_planes(p0: np.ndarray, p1: np.ndarray, num_shards: int):
    """Zero-pad the m dimension to a multiple of the model axis; zero rows
    contribute nothing to the products."""
    m = p0.shape[0]
    pad = (-m) % num_shards
    if pad:
        p0 = np.pad(p0, ((0, pad), (0, 0)))
        p1 = np.pad(p1, ((0, pad), (0, 0)))
    return p0, p1


@dataclass
class ShardedDigitPlane:
    """One int8 digit plane, its rows split in `model` equal shards.
    `shards` maps (s, device) to shard s on that device, zero-padded to the
    shape `torch._int_mm` takes (`matmul_u32.pad_plane`); one tensor
    however often the mesh names the pair."""

    mesh: Mesh
    shards: dict
    m_pad: int  # rows, a multiple of the model axis
    num_cols: int  # logical c

    @property
    def m_local(self) -> int:
        return self.m_pad // self.mesh.shape["model"]


def shard_db_planes(mesh: Mesh, p0: np.ndarray, p1: np.ndarray):
    """Place the (m, c) int8 digit planes on the mesh: m sharded over
    `model` (padded to a multiple of it), shared by the data rows. Returns
    the two ShardedDigitPlane."""
    p0, p1 = pad_db_planes(p0, p1, mesh.shape["model"])
    m_pad, c = p0.shape
    m_local = m_pad // mesh.shape["model"]
    out = []
    for p in (p0, p1):
        shards = {}
        for _, s, device in mesh.cells():
            if (s, device) not in shards:
                rows = np.ascontiguousarray(p[s * m_local : (s + 1) * m_local], np.int8)
                shards[s, device] = pad_plane(torch.from_numpy(rows).to(device))
        out.append(ShardedDigitPlane(mesh, shards, m_pad, c))
    return tuple(out)


def _respond_local(queries_u32: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
    """Local-shard respond partial: (Q, m_local) x (m_local, C) -> int32."""
    return _matmul_digits(queries_u32, d0, d1)


def _sharded_digit_product(mesh: Mesh, queries, d0: ShardedDigitPlane, d1: ShardedDigitPlane,
                           split_rows: bool) -> torch.Tensor:
    if queries.shape[1] != d0.m_pad:
        raise ValueError(f"query length {queries.shape[1]} != padded DB rows {d0.m_pad}")
    m_local, c = d0.m_local, d0.num_cols

    def add_partial(s, device, rows, out):
        q = queries[rows, s * m_local : (s + 1) * m_local].to(device)
        out[rows] += _respond_local(q, d0.shards[s, device], d1.shards[s, device])[:, :c]

    return _over_cells(mesh, queries.shape[0], c, split_rows, add_partial)


def sharded_respond_fn(mesh: Mesh):
    """respond(queries, d0, d1): (Q, m_pad) int32 u32-bit queries x the
    planes of `shard_db_planes` -> (Q, c) int32, query rows split over
    `data` (Q a multiple of it), m over `model`, the int32 partials summed
    exactly mod 2^32. The result lies on the mesh's first device, or on
    the host after a gloo reduction."""
    return lambda queries, d0, d1: _sharded_digit_product(mesh, queries, d0, d1, split_rows=True)


def sharded_hint_accumulate_fn(mesh: Mesh):
    """step(acc, a_u32, d0, d1): acc (R, c) int32 + A_block (R, m_pad) u32
    bits . D, as a new tensor where the reduction leaves it.

    A blocks are the same for every data row, their columns split over
    `model`; the shards' digit products are summed into the accumulator."""

    def step(acc, a_u32, d0, d1):
        total = _sharded_digit_product(mesh, a_u32, d0, d1, split_rows=False)
        return acc.to(total.device) + total

    return step
