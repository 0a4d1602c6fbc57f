"""The ray mesh: data parallelism over rays and pixel rows on torch.distributed.

Counterpart of realtimeraytracer_tpu/parallel/mesh.py (``RAY_AXIS``,
``make_ray_mesh``, ``initialize_multihost``, ``pad_to_multiple``).  The one
parallel axis is the same: rays (and the image's pixel rows) split into
contiguous slabs over the ranks, the scene replicated on each.

JAX is single-controller: ``shard_map`` over a ``Mesh`` of local devices,
with XLA inserting the collectives.  PyTorch runs one process per rank
(SPMD).  Every rank holds the replicated scene and the same global rays
(made from the same seed), computes its slab, and calls the collectives
itself, through the mesh's methods: the halo exchange of the row-sharded
denoise, the mean of the loss and of the gradients, and the gather of
image rows.  Each call appends its kind, rows and bytes to ``mesh.log``,
which the tests read where JAX's read the compiled program's collectives.

A mesh with a process group runs its collectives on it: gloo for CPU
tensors, NCCL for CUDA tensors; a mesh whose group's backend does not
serve its device raises, and so does a collective handed a tensor on
another device type (nothing is staged through the host).  A mesh of one
rank without a group runs no collective.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

RAY_AXIS = "rays"       # the mesh's one axis (the name JAX's shard_map specs use)

# The process-group backend that serves each device type.
_BACKEND = {"cpu": "gloo", "cuda": "nccl"}


@dataclasses.dataclass
class RayMesh:
    """A 1-D mesh over the ray axis: this process's rank of `size`, the
    device its slabs live on, and the process group (None: one rank, no
    collective).  `log` lists each collective run: {"kind": "halo" |
    "all_gather" | "all_reduce", "rows": rows per rank or None, "bytes":
    bytes this rank sent}."""

    group: object
    rank: int
    size: int
    device: torch.device
    log: list = dataclasses.field(default_factory=list)

    def slab(self, n: int, what: str = "rays") -> tuple[int, int]:
        """This rank's contiguous range [start, stop) of n items."""
        if n % self.size:
            raise ValueError(f"{n} {what} not divisible by {self.size} ranks; pick a "
                             "resolution that tiles over the mesh")
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r)

    def _check(self, tensors) -> None:
        for x in tensors:
            if x.device.type != self.device.type:
                raise ValueError(f"a collective of the mesh on {self.device} got a tensor on "
                                 f"{x.device}")

    def exchange_halo(self, tensors, halo: int) -> list:
        """The ring neighbours' edge rows of each (rows, ...) tensor:
        [(top, bottom)], top the previous rank's last `halo` rows and
        bottom the next rank's first `halo` rows, None where there is no
        neighbour.  One batch of point-to-point sends and receives."""
        out = [[None, None] for _ in tensors]
        if self.group is None or self.size == 1:
            return [tuple(x) for x in out]
        self._check(tensors)
        ops, sent = [], 0
        for i, x in enumerate(tensors):
            if self.rank > 0:
                out[i][0] = torch.empty_like(x[:halo])
                ops += [dist.P2POp(dist.isend, x[:halo].contiguous(), self._peer(self.rank - 1),
                                   self.group, tag=2 * i),
                        dist.P2POp(dist.irecv, out[i][0], self._peer(self.rank - 1), self.group,
                                   tag=2 * i + 1)]
                sent += x[:halo].nbytes
            if self.rank < self.size - 1:
                out[i][1] = torch.empty_like(x[-halo:])
                ops += [dist.P2POp(dist.isend, x[-halo:].contiguous(), self._peer(self.rank + 1),
                                   self.group, tag=2 * i + 1),
                        dist.P2POp(dist.irecv, out[i][1], self._peer(self.rank + 1), self.group,
                                   tag=2 * i)]
                sent += x[-halo:].nbytes
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.log.append({"kind": "halo", "rows": halo, "bytes": sent})
        return [tuple(x) for x in out]

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's (rows, ...) slab, concatenated in rank order (the
        same shape on every rank)."""
        if self.group is None:
            return x
        self._check([x])
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        self.log.append({"kind": "all_gather", "rows": x.shape[0], "bytes": x.nbytes})
        return torch.cat(parts)

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of x: the sum, then divided by the rank
        count (x itself on a mesh without a group)."""
        if self.group is None:
            return x
        self._check([x])
        total = x.detach().clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        self.log.append({"kind": "all_reduce", "rows": None, "bytes": total.nbytes})
        return total / self.size


def make_ray_mesh(n_devices: int | None = None,
                  device: str | torch.device | None = None) -> RayMesh:
    """A 1-D mesh over the ray axis on `device` (default cuda:LOCAL_RANK;
    the CPU only when asked).  With a process group initialised, the mesh
    spans all its ranks (n_devices None or the world size) or this rank
    alone (n_devices=1, no collective); without one, it is a one-rank mesh
    that runs no collective."""
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type not in _BACKEND:
        raise ValueError(f"no ray mesh on {device}: the CPU (gloo) or CUDA (NCCL)")
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} present")
    if not grouped or n == 1 < world:
        return RayMesh(None, 0, 1, device)
    if n != world:
        raise ValueError(f"a ray mesh spans one rank or all {world} ranks of the process "
                         f"group, not {n}")
    backend = str(dist.get_backend())
    if _BACKEND[device.type] not in backend:
        raise ValueError(f"a ray mesh on {device} needs a {_BACKEND[device.type]} process "
                         f"group; this one's backend is {backend}")
    return RayMesh(dist.group.WORLD, dist.get_rank(), world, device)


def initialize_multihost(**kwargs) -> None:
    """Bring up the process group: torch.distributed.init_process_group(
    **kwargs), or from the launcher's environment (torchrun's RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  A no-op when a group already
    exists, or when neither kwargs nor that environment is there (one
    process).  Nothing is queried before the init."""
    if dist.is_initialized():
        return
    if not kwargs and not any(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return
    dist.init_process_group(**kwargs)


def pad_to_multiple(n: int, m: int) -> int:
    """The least multiple of m at or above n (a ray count that tiles over m
    ranks)."""
    return -(-n // m) * m
