// Copy-engine copies for the key mesh's masks gather: each card's [R, L]
// masks into their column slice of one [R, N] result on the first card.
//
// Built at first use by merklekv_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
// in parallel with the other sources, and linked with them into one
// library with a plain C interface (mkv_error_string is defined in
// sha256_kernels.cu); cuda_lib.py binds the entry points with ctypes and
// ops/mesh_copy.py wraps them. Host code
// only: no kernel. The copy takes the caller's stream, allocates nothing,
// never synchronises, and returns its error code (0 = queued).
//
// Replaces no Pallas kernel. It replaces torch.cat of the cards' masks on
// the first card (parallel/sharded_merkle.py), which copied every peer's
// masks to a temporary and then all of them again into the result with an
// elementwise kernel on the SMs. One cudaMemcpy2DAsync writes a card's
// rows straight into its column slice (source pitch L bytes, destination
// pitch N bytes, R rows): peer to peer, the source card's copy engines move
// it over NVLink while the SMs run other work. Within one card CUDA's
// copy waited for free SMs under a running kernel, so the caller queues
// that one last.
//
// What bounds it on an H100: NVLink into the first card, 450 GB/s each way,
// once peer access is on (one [64, 16.5M] byte slice took 2.66 ms, about
// 397 GB/s, with every card's SMs busy); without peer access CUDA
// stages the copy through the host. mkv_enable_peer_access turns it on
// before the first copy.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

// Let `device` reach `peer`'s memory directly. Access already on is no
// error. The calling thread's current device is left as it was.
int mkv_enable_peer_access(int32_t device, int32_t peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear it: nothing failed
      err = cudaSuccess;
    }
  }
  cudaError_t restored = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restored);
}

// rows x width bytes from src (row pitch src_pitch) to dst (row pitch
// dst_pitch), on `stream`; either pointer may lie on any card.
int mkv_copy_2d(void* dst, int64_t dst_pitch, const void* src, int64_t src_pitch,
                int64_t width, int64_t rows, void* stream) {
  if (width <= 0 || rows <= 0) return 0;
  cudaError_t err = cudaMemcpy2DAsync(dst, static_cast<size_t>(dst_pitch), src,
                                      static_cast<size_t>(src_pitch), static_cast<size_t>(width),
                                      static_cast<size_t>(rows), cudaMemcpyDefault,
                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();  // not left for the next launch to report
  return static_cast<int>(err);
}

}  // extern "C"
