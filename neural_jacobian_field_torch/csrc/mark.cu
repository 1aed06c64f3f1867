// The device mark of utils/profiling.py: one thread writes the device's
// global nanosecond timer into one slot of a program's mark buffer.
//
// A layer boundary inside a captured program is a launch of this kernel on
// the program's stream; the capture makes it a kernel node, so every replay
// writes the slot again with the time at which the work before it had
// finished and the work after it had not started (the stream orders them).
// A CUDA event recorded into the capture does the same as an event-record
// node, but on the H100 each such node stalls the graph for about 4.3 us
// against about 0.8 us for this kernel's node, which is what the marks of a
// 100-iteration solve could not afford.

#include <cuda_runtime.h>

__global__ void njf_mark_kernel(unsigned long long* slot) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    *slot = t;
}

extern "C" int njf_mark(void* slot, void* stream) {
    njf_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)slot);
    return (int)cudaGetLastError();
}
