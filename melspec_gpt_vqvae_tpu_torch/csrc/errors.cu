// Error text for the codes the kernel entry points return.
#include "common.cuh"

MSGV_API const char* msgv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
