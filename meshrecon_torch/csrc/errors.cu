// Error text for the codes the entry points return.
#include "common.cuh"

MR_EXPORT const char* mr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
