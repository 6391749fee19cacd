// Error reporting for the ctypes wrappers: the launchers return the raw
// cudaError_t of cudaGetLastError(), and this turns it into text.
#include "common.cuh"

REPRO_EXPORT const char* repro_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// An empty kernel that the port's tracing launches at each edge of a phase
// while a recording is open on a card (`kernels/build.py` `span_mark`): in a
// device trace the operations between two marks are the phase's, in the
// stream's order, whatever the host's and the device's clocks say.
__global__ void span_mark_kernel() {}

REPRO_EXPORT int repro_span_mark(void* stream) {
    span_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
