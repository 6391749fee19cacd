// Error reporting for the ctypes wrappers: the launchers return the raw
// cudaError_t of cudaGetLastError(), and this turns it into text.
#include "common.cuh"

REPRO_EXPORT const char* repro_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
