// Entry points shared by every kernel of the library.
#include <cuda_runtime.h>

// The message of a cudaError_t that a kernel's entry point returned.
extern "C" const char* aeg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
