"""The blocks of a tp view on the card, shared between the ranks of a tp
group (``csrc/peer.cu``).

Each rank allocates its block of every table the kernels read with
``cudaMalloc`` (:func:`alloc`: an IPC handle names a whole allocation, so
the block is one), exports its 64-byte handle, and opens the handles of
its peers, which ``dist.all_gather_object`` brings it over the tp group.
The view's device table of a table's blocks then holds this rank's own
pointer at its coordinate (a process cannot open its own handle) and the
mapped pointers of its peers elsewhere.  Two ranks on one card share the
block through a second mapping; on two cards the reader reads it over
NVLink, which needs ``cudaDeviceCanAccessPeer``: where a pair of cards
lacks it, :func:`exchange` raises.  Nothing is ever copied in place of a
mapping.

:meth:`Peers.close` is the teardown, and every rank of the group calls
it: each closes the mappings it opened, the group meets at a barrier, and
only then does each free its own blocks, so no rank frees a block that a
peer still maps.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.distributed as dist

from bwt_tpu_torch.ops import _kernels
from bwt_tpu_torch.ops._kernels import check_launch as _check

HANDLE_BYTES = 64


class Block:
    """Device memory from ``cudaMalloc`` (``peer_alloc``), seen by torch
    through ``__cuda_array_interface__`` (:func:`alloc`).  Freed by
    :meth:`free`, or when the last tensor over it goes."""

    def __init__(self, device: torch.device, shape: tuple, dtype):
        self.device = device
        self.shape = tuple(int(n) for n in shape)
        self.dtype = dtype
        self.ptr = None  # until the allocation succeeds
        nbytes = dtype.itemsize
        for n in self.shape:
            nbytes *= n
        ptr = ctypes.c_void_p()
        _check(_kernels.library().peer_alloc(device.index, nbytes,
                                             ctypes.byref(ptr)),
               "cudaMalloc of a tp block")
        self.ptr = ptr.value
        self.nbytes = nbytes

    @property
    def __cuda_array_interface__(self) -> dict:
        typestr = {torch.int32: "<i4", torch.int64: "<i8"}[self.dtype]
        return dict(shape=self.shape, typestr=typestr, data=(self.ptr, False),
                    version=2, strides=None)

    def handle(self) -> bytes:
        """The block's IPC handle, for the peers to open."""
        buf = ctypes.create_string_buffer(HANDLE_BYTES)
        _check(_kernels.library().peer_export(self.ptr, buf),
               "cudaIpcGetMemHandle")
        return buf.raw

    def free(self) -> None:
        if self.ptr is not None:
            ptr, self.ptr = self.ptr, None
            _check(_kernels.library().peer_free(ptr), "cudaFree of a tp block")

    def __del__(self):
        if self.ptr is not None and _kernels._lib is not None:
            _kernels._lib.peer_free(self.ptr)
            self.ptr = None


def alloc(src: torch.Tensor, device: torch.device) -> tuple[Block, torch.Tensor]:
    """A block of its own allocation on ``device`` holding a copy of
    ``src``: the block and an int32 tensor over it."""
    block = Block(device, src.shape, src.dtype)
    t = torch.as_tensor(block, device=device)
    t.copy_(src)
    return block, t


def _bus_id(device: torch.device) -> str:
    buf = ctypes.create_string_buffer(32)
    _check(_kernels.library().peer_bus_id(device.index, buf, len(buf)),
           "cudaDeviceGetPCIBusId")
    return buf.value.decode()


def _peer_device(bus: str) -> int:
    dev = ctypes.c_int()
    _check(_kernels.library().peer_device_of(bus.encode(), ctypes.byref(dev)),
           f"cudaDeviceGetByPCIBusId({bus})")
    return dev.value


@dataclasses.dataclass(eq=False)
class Peers:
    """What a rank holds for a tp view on the card: its own blocks and the
    pointers of the peers' blocks it mapped.  ``group`` is the tp group
    (None for a view made in one process, which opened nothing)."""
    own: list
    opened: list
    group: object = None
    device: torch.device | None = None
    closed: bool = False

    def close(self) -> None:
        """The group's teardown (every rank calls it): wait for this rank's
        kernels, close its mappings, meet the group at a barrier, then free
        its own blocks."""
        if self.closed:
            return
        self.closed = True
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        lib = _kernels.library()
        for ptr in self.opened:
            _check(lib.peer_close(ptr), "cudaIpcCloseMemHandle")
        self.opened = []
        if self.group is not None:
            dist.barrier(group=self.group)
        for block in self.own:
            block.free()
        self.own = []


def exchange(blocks: dict, coord: int, size: int, group,
             device: torch.device) -> tuple[dict, Peers]:
    """Every rank of the tp group's pointer of each table's block:
    ``blocks`` maps a table's name to this rank's :class:`Block`.  The
    handles and the cards' bus ids go round with ``all_gather_object``;
    this rank opens each peer's handle (its own pointer stays at
    ``coord``).  Returns ({name: [pointer of block j, j < size]}, the
    :class:`Peers` to close).  A peer on a card this one cannot read
    raises, as does a handle that does not open."""
    lib = _kernels.library()
    mine = (_bus_id(device), {name: b.handle() for name, b in blocks.items()})
    got = [None] * size
    dist.all_gather_object(got, mine, group=group)
    peers = Peers(own=list(blocks.values()), opened=[], group=group,
                  device=device)
    ptrs = {name: [0] * size for name in blocks}
    try:
        for j, (bus, handles) in enumerate(got):
            if j == coord:
                for name, b in blocks.items():
                    ptrs[name][j] = b.ptr
                continue
            if bus != mine[0]:
                other = _peer_device(bus)
                can = ctypes.c_int()
                _check(lib.peer_can_access(device.index, other,
                                           ctypes.byref(can)),
                       "cudaDeviceCanAccessPeer")
                if not can.value:
                    raise RuntimeError(
                        f"tp rank {coord}'s card ({mine[0]}) cannot read "
                        f"rank {j}'s card ({bus}) directly "
                        f"(cudaDeviceCanAccessPeer is false); a tp view reads "
                        f"its peers' blocks in place and never copies them")
            for name in blocks:
                ptr = ctypes.c_void_p()
                _check(lib.peer_open(device.index, handles[name],
                                     ctypes.byref(ptr)),
                       f"cudaIpcOpenMemHandle of tp rank {j}'s {name} block")
                peers.opened.append(ptr.value)
                ptrs[name][j] = ptr.value
    except Exception:
        for ptr in peers.opened:
            lib.peer_close(ptr)
        peers.opened = []
        raise
    return ptrs, peers
