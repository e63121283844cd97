// The one error-text export of the kernel library: every launcher returns
// cudaGetLastError() as an int, and the Python wrapper turns a nonzero code
// into a message through this function.

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
