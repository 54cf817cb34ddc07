"""The process group of the port's data-parallel fit and its collectives.

JAX runs data parallelism as one program over a mesh; PyTorch runs one
process per rank, joined by a ``torch.distributed`` group.  A
:class:`Group` wraps such a group with its rank, its size and its backend,
which the caller always names: ``"nccl"`` for one card per rank,
``"gloo"`` on the CPU (and for several ranks sharing one card, where gloo
carries CUDA tensors through the host).  Nothing picks the backend from
what is present, and no tensor changes device: a tensor the backend cannot
carry raises.

Every collective is built from ``all_reduce`` (SUM and MAX) and
``broadcast``, the operations gloo and NCCL both carry for CUDA tensors.
A gather is an ``all_reduce`` SUM of a zero-filled buffer into which each
rank writes its own slot: adding zeros is exact, so the gather is
bit-exact on every backend, and a sum taken afterwards in rank order
(:meth:`Group.sum_in_rank_order`) has the same bits on every rank and
every backend.  ``Group.bytes`` counts the bytes of every buffer a
collective carried.

:func:`init_group` joins a group through a ``FileStore``
(``init_method="file://..."``), so several groups on one host never
contend for a TCP port; under ``torchrun`` call
``torch.distributed.init_process_group`` yourself and wrap the default
group with ``Group()``.

A rank of a (data, model) mesh (``launch/mesh.Mesh``, laid over a
group's ranks data-major) works in three groups: the mesh's ranks, its
data column (the ranks that hold its model coordinate, over every batch
axis) and its model row (the ranks that hold its batch coordinates).
``Group.mesh_groups(mesh)`` builds every column and row of the mesh up
front, in one order on every rank (``dist.new_group`` is collective over
the whole job), and returns this rank's :class:`MeshGroups`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

#: the device types each backend carries
CARRIES = {"gloo": ("cpu", "cuda"), "nccl": ("cuda",)}
#: bytes of a DeviceLost message carried by ``broadcast_text``
TEXT_BYTES = 512


def init_group(backend: str, rank: int, world: int, init_file: str
               ) -> "Group":
    """Join the default group of ``world`` ranks as ``rank`` through the
    file store at ``init_file`` (a path every rank can reach, absent or
    empty before the first rank joins); returns it as a :class:`Group`."""
    if backend not in CARRIES:
        raise ValueError(f"backend must be one of {sorted(CARRIES)}, not "
                         f"{backend!r}")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    return Group()


class Group:
    """A ``torch.distributed`` process group (the default group when
    ``pg`` is None) with its rank and size, and the fit's collectives."""

    def __init__(self, pg=None):
        self.pg = dist.group.WORLD if pg is None else pg
        self.rank = dist.get_rank(self.pg)
        self.size = dist.get_world_size(self.pg)
        self.backend = str(dist.get_backend(self.pg))
        if self.backend not in CARRIES:
            raise ValueError(f"a Group runs on {sorted(CARRIES)}, not the "
                             f"{self.backend!r} backend")
        self.bytes = 0

    def __repr__(self) -> str:
        return (f"Group(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r})")

    def _carry(self, t: torch.Tensor) -> None:
        if t.device.type not in CARRIES[self.backend]:
            raise ValueError(
                f"the {self.backend} backend does not carry {t.device.type} "
                f"tensors; move the fit to a device it carries or name "
                f"another backend")
        self.bytes += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place on ``t`` (contiguous): the SUM or MAX over the ranks."""
        self._carry(t)
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=self.pg)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """In place on ``t``: group rank ``src``'s values on every rank."""
        self._carry(t)
        dist.broadcast(t, src=dist.get_global_rank(self.pg, src),
                       group=self.pg)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t``, bit-exact (a zero-filled
        buffer, this rank's slot written, summed over the ranks)."""
        buf = t.new_zeros((self.size,) + tuple(t.shape))
        buf[self.rank] = t
        return self.all_reduce(buf)

    def sum_in_rank_order(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, added in rank order: the same
        bits on every rank and every backend."""
        parts = self.gather(t)
        total = parts[0]
        for r in range(1, self.size):
            total = total + parts[r]
        return total

    def gather_rows(self, x: torch.Tensor, lo: int, total: int
                    ) -> torch.Tensor:
        """(total, ...) rows of which this rank holds ``x`` at ``lo``; the
        ranks' row ranges are disjoint.  Differentiable: the gradient of
        ``x`` is this rank's own rows of the output's gradient (every rank
        differentiates the same loss, so nothing is summed over ranks)."""
        return _GatherRows.apply(x, self, lo, total)

    def flag_max(self, value: int, device) -> int:
        """The largest of the ranks' ``value``s (one int32 all_reduce)."""
        t = torch.tensor([value], dtype=torch.int32, device=device)
        return int(self.all_reduce(t, "max").item())

    def barrier(self, device) -> None:
        """Return once every rank has called it."""
        self.flag_max(0, device)

    def broadcast_text(self, text: str, src: int, device) -> str:
        """``text`` of group rank ``src`` (at most TEXT_BYTES bytes of its
        UTF-8) on every rank."""
        buf = torch.zeros(TEXT_BYTES, dtype=torch.uint8, device=device)
        if self.rank == src:
            raw = text.encode()[:TEXT_BYTES]
            buf[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
        raw = bytes(self.broadcast(buf, src).cpu().tolist())
        return raw.rstrip(b"\0").decode(errors="replace")

    def mesh_groups(self, mesh) -> Optional["MeshGroups"]:
        """This rank's groups on ``mesh`` (a mesh of this group's first
        ``mesh.size`` ranks, the model axis last).  Every rank of the job
        must call it, in the same order; a rank outside the mesh gets
        None.  Raises ValueError for a mesh wider than the group."""
        n = mesh.size
        if n > self.size:
            raise ValueError(f"a {tuple(mesh.shape)} mesh needs {n} ranks; "
                             f"the group has {self.size}")
        world = self.subgroup(n)
        ms = mesh.shape[-1]

        def new(members):
            pg = dist.new_group([dist.get_global_rank(self.pg, r)
                                 for r in members], backend=self.backend)
            return Group(pg) if self.rank in members else None

        cols = [new([d * ms + m for d in range(n // ms)]) for m in range(ms)]
        rows = [new([d * ms + m for m in range(ms)]) for d in range(n // ms)]
        if world is None:
            return None
        me = self.rank
        return MeshGroups(mesh, me, world, cols[me % ms], rows[me // ms])

    def subgroup(self, n: int) -> Optional["Group"]:
        """The group of this group's first ``n`` ranks (``self`` when n is
        the size).  Every rank of the job must call it, in the same order;
        a rank outside the first n gets None."""
        if n == self.size:
            return self
        pg = dist.new_group([dist.get_global_rank(self.pg, r)
                             for r in range(n)], backend=self.backend)
        return Group(pg) if self.rank < n else None


class MeshGroups(NamedTuple):
    """A rank's place on a mesh of ranks: its index (data-major), the
    mesh's group, its data column and its model row."""
    mesh: object
    index: int
    world: Group
    data: Group
    model: Group

    @property
    def coords(self) -> tuple:
        from repro_torch.distributed.sharding import mesh_coords

        return mesh_coords(self.mesh, self.index)

    @property
    def groups(self) -> tuple:
        """The distinct groups, each once."""
        out = []
        for g in (self.world, self.data, self.model):
            if all(g is not o for o in out):
                out.append(g)
        return tuple(out)

    @property
    def bytes(self) -> int:
        """The bytes every collective of the three groups carried."""
        return sum(g.bytes for g in self.groups)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, lo, total):
        ctx.lo, ctx.n = lo, x.shape[0]
        buf = x.new_zeros((total,) + tuple(x.shape[1:]))
        buf[lo:lo + x.shape[0]] = x
        return group.all_reduce(buf)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo:ctx.lo + ctx.n], None, None, None
