// Error text for the status codes the kernel entry points return (their
// cudaGetLastError() after the launch), from the same CUDA runtime that
// launched them.

#include <cuda_runtime.h>

extern "C" const char* stt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
