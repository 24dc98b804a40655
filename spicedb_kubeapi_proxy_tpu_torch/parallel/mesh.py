"""Mesh construction for the sharded engine.

Counterpart of the JAX package's ``parallel/mesh.py``. One 2-D mesh,
axes ``("data", "graph")``:

- ``data``  — data parallelism over concurrent queries (requests);
- ``graph`` — edge-tensor parallelism within one query (the graph, not
  weights, is the big operand).

Where the reference lays XLA devices out, the port lays out **cells**: a
cell is ``(rank, torch.device)``, one process of the ``torch.distributed``
world and one device it drives. Each process runs the cells of its own
rank (parallel/sharded.py). By default the mesh takes every CUDA card of
every rank (``torch.cuda.device_count()`` x the world size; the local
cards alone when no process group exists). An explicit ``devices`` list
may repeat a device: the port's stand-in for XLA's
``--xla_force_host_platform_device_count``, so the CPU tests run 8 cells
on one CPU (``[torch.device("cpu")] * 8``) and two cells can share one
card.

Axis sizes must multiply to the cell count. By default the graph axis
takes as many cells as possible while keeping the data axis at least 2
when there are at least 4 cells and their count is even: list latency is
bounded by one query's propagation, which only the graph axis splits,
while throughput under concurrency comes from the data axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class MeshSpecError(ValueError):
    pass


class Cell(NamedTuple):
    """One mesh position: the process (``rank``) that runs it and the
    device it runs on."""

    rank: int
    device: torch.device


def _world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A ``(data, graph)`` grid of :class:`Cell` s (``devices``, an object
    array) with this process's rank. In a world of several processes it
    holds the process groups the sharded fixpoint joins over, made in the
    same order on every rank: one per data row whose cells span more
    than one rank (the ``graph`` join), and the mesh's ranks (the change
    flags and the output rows); ``None`` where no collective is needed or
    the whole world takes part."""

    def __init__(self, cells: np.ndarray):
        self.devices = cells
        self.shape = {"data": int(cells.shape[0]),
                      "graph": int(cells.shape[1])}
        self.rank, self.world = _world()
        ranks = sorted({c.rank for c in cells.reshape(-1)})
        if self.world == 1 and ranks != [0]:
            raise ValueError(f"cells name ranks {ranks} but this process "
                             "has no torch.distributed world")
        self.row_groups: dict = {}
        self.mesh_group = None
        self.multi = self.world > 1
        # whether some rank lacks a data row: the output rows must then be
        # gathered over the data axis (decided from the whole grid, so
        # every rank makes the same call)
        self.gather_rows = self.multi and any(
            {c.rank for c in cells[r]} != set(ranks)
            for r in range(self.shape["data"]))
        if self.multi:
            import torch.distributed as dist

            for r in range(self.shape["data"]):
                row = sorted({c.rank for c in cells[r]})
                # every rank calls new_group for every group, in order
                self.row_groups[r] = (dist.new_group(row) if len(row) > 1
                                      else None)
            if ranks != list(range(self.world)):
                self.mesh_group = dist.new_group(ranks)
            if self.rank not in ranks:
                raise ValueError(f"rank {self.rank} holds no cell of the "
                                 "mesh")

    def local_cells(self) -> list:
        """``[(data row, graph index, device), ...]`` of this process."""
        D, G = self.devices.shape
        return [(r, g, self.devices[r, g].device)
                for r in range(D) for g in range(G)
                if self.devices[r, g].rank == self.rank]

    def row_is_split(self, r: int) -> bool:
        """Whether data row ``r``'s cells span more than one rank."""
        return self.row_groups.get(r) is not None


def mesh_topology(mesh: Mesh) -> dict:
    """One-line description of a mesh's cell topology, the label logs and
    measurements attach to mesh-path numbers: ``{"devices": N, "data": D,
    "graph": G, "platform": "cuda"|"cpu"}``."""
    devs = mesh.devices.reshape(-1)
    return {
        "devices": int(devs.size),
        "data": int(mesh.shape["data"]),
        "graph": int(mesh.shape["graph"]),
        "platform": str(devs[0].device.type) if devs.size else "none",
    }


def parse_mesh_spec(spec: str) -> dict:
    """"auto" -> {} (all devices, derived axes); "data=D,graph=G" ->
    explicit axis sizes (either may be omitted). Raises MeshSpecError."""
    if spec == "auto":
        return {}
    out: dict = {}
    for part in spec.split(","):
        k, sep, v = part.partition("=")
        if not sep or k.strip() not in ("data", "graph") \
                or not v.strip().isdigit() or int(v) < 1:
            raise MeshSpecError(
                f"invalid engine mesh {spec!r} "
                "(expected 'auto' or 'data=D,graph=G')")
        out[k.strip()] = int(v)
    return out


def default_devices(device_type: str = "cuda") -> list:
    """The cells of every rank of the world: each rank's CUDA cards
    (``cuda``; a missing card raises, nothing falls back) or one CPU cell
    a rank (``cpu``)."""
    _, world = _world()
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was requested but "
                               "torch.cuda.is_available() is False")
        local = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    elif device_type == "cpu":
        local = [torch.device("cpu")]
    else:
        raise ValueError(f"unsupported mesh device type {device_type!r}")
    return [Cell(r, d) for r in range(world) for d in local]


def cpu_devices(data: Optional[int] = None,
                graph: Optional[int] = None) -> list:
    """CPU cells for a mesh spec: ``data * graph`` of them (one axis given:
    that many), split evenly over the world's ranks; no axis given, one a
    rank."""
    _, world = _world()
    if data is None and graph is None:
        return default_devices("cpu")
    total = (data or 1) * (graph or 1)
    if total % world:
        raise ValueError(f"{total} CPU cells do not split evenly over "
                         f"{world} processes")
    cpu = torch.device("cpu")
    return [Cell(r, cpu) for r in range(world) for _ in range(total // world)]


def _as_cell(d) -> Cell:
    if isinstance(d, Cell):
        return d
    if isinstance(d, tuple) and len(d) == 2:
        return Cell(int(d[0]), torch.device(d[1]))
    # a bare device belongs to this process
    return Cell(_world()[0], torch.device(d))


def make_mesh(
    n_devices: Optional[int] = None,
    data: Optional[int] = None,
    graph: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build the ``("data", "graph")`` mesh over ``n_devices`` cells.

    Any of ``data`` / ``graph`` may be given; missing sizes are derived.
    ``devices`` overrides the cell list (default: :func:`default_devices`,
    every CUDA card of every rank); its entries are :class:`Cell` s,
    ``(rank, device)`` pairs, or devices of this process, and may repeat.
    """
    if devices is None:
        devices = default_devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = [_as_cell(d) for d in list(devices)[:n_devices]]
    if len(devices) < n_devices:
        raise ValueError(
            f"requested {n_devices} devices, only {len(devices)} available"
        )
    if data is None and graph is None:
        data = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
        graph = n_devices // data
    elif data is None:
        if n_devices % graph:
            raise ValueError(f"graph={graph} does not divide {n_devices}")
        data = n_devices // graph
    elif graph is None:
        if n_devices % data:
            raise ValueError(f"data={data} does not divide {n_devices}")
        graph = n_devices // data
    if data * graph != n_devices:
        raise ValueError(
            f"data*graph = {data}*{graph} != n_devices = {n_devices}"
        )
    arr = np.empty(n_devices, dtype=object)
    for i, c in enumerate(devices):  # element-wise: a Cell is a tuple
        arr[i] = c
    return Mesh(arr.reshape(data, graph))


def mesh_from_spec(spec: str, device) -> Mesh:
    """The mesh of an ``--engine-mesh`` spec (:func:`parse_mesh_spec`) for
    an engine on ``device``: every CUDA card of the world on ``cuda``;
    on the CPU, the spec's count of CPU cells (:func:`cpu_devices`).
    Raises MeshSpecError, or ValueError when the axes do not fit."""
    axes = parse_mesh_spec(spec)
    if torch.device(device).type == "cpu":
        return make_mesh(devices=cpu_devices(**axes), **axes)
    return make_mesh(**axes)
