"""The row mesh of the distributed schedules: P ranks of a torch.distributed
process group, one device each, along one axis (the reference's "rows"),
and the three collectives the schedules use.

The reference package runs one program over a JAX device mesh
(``jax.shard_map``) and moves data with ``jax.lax.ppermute`` and
``jax.lax.ragged_all_to_all``. Here each rank is a process that drives one
device, so a schedule's per-shard body runs once in every rank, and:

- ``ring_shift`` sends to the rank ``offset`` places on and receives from
  the rank as far back (``ppermute``), by ``batch_isend_irecv``; it returns
  before the data arrives, so the caller computes meanwhile;
- ``all_to_all_v`` is the ragged all-to-all with split sizes the host plan
  knows (``all_to_all_single``);
- ``all_gather_v`` stacks every rank's leading slice on every rank (the
  gather behind ``dist.unshard``).

NCCL carries CUDA tensors and gloo CPU tensors. A tensor on the other kind
of device raises: no collective changes backend.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

# the device type each backend carries
_BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks. ``ranks`` are the members' global ranks in
    mesh order, ``rank`` this process's position among them, ``device``
    the device it drives and ``group`` their process group (None: the
    default group)."""

    ranks: tuple
    rank: int
    device: torch.device
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def _check(self, t: torch.Tensor) -> None:
        want = _BACKEND_DEVICE.get(self.backend)
        if want is None:
            raise ValueError(f"backend {self.backend!r}: the mesh takes "
                             f"{sorted(_BACKEND_DEVICE)}")
        if t.device.type != want:
            raise ValueError(f"a {t.device.type} tensor cannot travel on "
                             f"{self.backend}, which carries {want} tensors")

    def ring_shift(self, t: torch.Tensor, offset: int,
                   block: int | None = None) -> "Pending":
        """Send ``t`` to the rank ``offset`` places on and receive the same
        shape from the rank ``offset`` places back, within aligned blocks
        of ``block`` ranks (default: the whole ring). Returns at once; the
        result's ``wait()`` gives the received tensor. A shift onto the
        rank itself is a copy: gloo refuses a pair with itself."""
        self._check(t)
        block = block or self.size
        base = self.rank - self.rank % block
        dst = base + (self.rank - base + offset) % block
        src = base + (self.rank - base - offset) % block
        t = t.contiguous()
        if dst == self.rank:
            return Pending(t.clone(), (), t)
        out = torch.empty_like(t)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, self.ranks[dst], group=self.group),
            dist.P2POp(dist.irecv, out, self.ranks[src], group=self.group),
        ])
        return Pending(out, tuple(works), t)

    def all_to_all_v(self, t: torch.Tensor, send_sizes, recv_sizes
                     ) -> torch.Tensor:
        """Ragged all-to-all along the first axis: ``t``'s consecutive
        slices of ``send_sizes[j]`` rows go to rank j, and the result holds
        ``recv_sizes[i]`` rows from each rank i, in rank order. The sizes
        are host ints."""
        self._check(t)
        send = [int(x) for x in send_sizes]
        recv = [int(x) for x in recv_sizes]
        out = t.new_empty((sum(recv),) + tuple(t.shape[1:]))
        dist.all_to_all_single(out, t[: sum(send)].contiguous(), recv, send,
                               group=self.group)
        return out

    def all_gather_v(self, t: torch.Tensor, sizes) -> torch.Tensor:
        """Every rank's first ``sizes[rank]`` rows of ``t``, stacked on
        every rank as (P, max(sizes), ...), zero past each rank's own. The
        sizes are host ints, the same list on every rank."""
        self._check(t)
        sizes = [int(x) for x in sizes]
        mine = sizes[self.rank]
        buf = t.new_zeros((max(sizes),) + tuple(t.shape[1:]))
        buf[:mine] = t[:mine]
        out = t.new_empty((self.size,) + tuple(buf.shape))
        dist.all_gather(list(out.unbind(0)), buf, group=self.group)
        return out


@dataclasses.dataclass(frozen=True)
class Pending:
    """A posted ``ring_shift``: ``wait()`` orders the caller after the
    exchange (on NCCL, the current stream after NCCL's, with no host
    synchronize) and returns the received tensor. It holds the sent tensor
    until then."""

    out: torch.Tensor
    works: tuple
    sent: torch.Tensor

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        return self.out


def default_device() -> torch.device:
    """The device a rank of the default group drives: the current CUDA
    device on NCCL, the CPU on gloo."""
    backend = dist.get_backend()
    if backend not in _BACKEND_DEVICE:
        raise ValueError(f"backend {backend!r}: the mesh takes "
                         f"{sorted(_BACKEND_DEVICE)}")
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: int | None = None, device=None) -> Mesh | None:
    """A mesh over the first ``n_devices`` ranks of the initialized default
    group (all of them by default). Every rank must call it; a rank outside
    the mesh gets None."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized "
                           "(parallel.bootstrap.init_multihost)")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    device = default_device() if device is None else torch.device(device)
    return Mesh(tuple(range(n)), rank, device, group)
