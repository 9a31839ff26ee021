// Device blocks shared between the processes of a tp group: the blocks of
// a tp-sharded index (bwt_tpu_torch/parallel/peer.py), which every search
// kernel reads through a table of their device pointers (fm::IndexTp,
// fm_rank.cuh).
//
// A block is allocated here with cudaMalloc, not by PyTorch's caching
// allocator: an IPC handle names a whole allocation, and a block made by
// cudaMalloc is one, so the pointer a peer opens is the block's first
// byte.  The owner exports a 64-byte handle (cudaIpcGetMemHandle); every
// other rank of the group opens it (cudaIpcOpenMemHandle with
// cudaIpcMemLazyEnablePeerAccess), which maps the block into its address
// space: on the same card as a second mapping, on another card of the host
// over NVLink.  A process cannot open its own handle: it reads its block
// through the pointer it allocated.  Before the owner frees a block, every
// peer closes its mapping (cudaIpcCloseMemHandle) and the group meets at a
// barrier (parallel/peer.py keeps that order).
//
// The functions return the CUDA error (0 on success) and allocate nothing
// else; none launches a kernel.

#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

static_assert(sizeof(cudaIpcMemHandle_t) == 64, "an IPC handle is 64 bytes");

// A block of `bytes` on `device`, zeroed.
extern "C" int peer_alloc(int device, size_t bytes, void** ptr) {
  *ptr = nullptr;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, bytes > 0 ? bytes : 1);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, bytes > 0 ? bytes : 1);
  return static_cast<int>(e);
}

extern "C" int peer_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// The 64-byte handle of a block made by peer_alloc.
extern "C" int peer_export(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(e);
}

// Map a peer's block, named by its handle, into this process on `device`.
extern "C" int peer_open(int device, const void* handle, void** ptr) {
  *ptr = nullptr;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  }
  return static_cast<int>(e);
}

extern "C" int peer_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// The PCI bus id of `device` ("0000:1b:00.0"), which names a card the same
// way in every process, whatever its ordinal there.
extern "C" int peer_bus_id(int device, char* out, int len) {
  return static_cast<int>(cudaDeviceGetPCIBusId(out, len, device));
}

// This process's ordinal of the card with PCI bus id `bus`.
extern "C" int peer_device_of(const char* bus, int* device) {
  return static_cast<int>(cudaDeviceGetByPCIBusId(device, bus));
}

// Whether `device` can read `peer`'s memory directly (NVLink or PCIe).
extern "C" int peer_can_access(int device, int peer, int* can) {
  return static_cast<int>(cudaDeviceCanAccessPeer(can, device, peer));
}
