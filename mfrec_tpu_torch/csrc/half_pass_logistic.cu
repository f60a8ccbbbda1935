// K1 on Hopper, built for the logistic link on bf16 fixed rows.
//
// The kernel, its design and what bounds it are in half_pass.cuh; this
// file fixes its compile-time options.  The four K1 builds
// (half_pass{,_f32,_logistic,_logistic_f32}.cu) are separate libraries,
// so that one nvcc per build compiles them side by side.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC.  Plain C interface, loaded by ctypes.

#define K1_LOGISTIC 1
#define K1_FF16 1
#include "half_pass.cuh"
