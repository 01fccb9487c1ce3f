// Shared macros for the Ed25519 verify kernels.
//
// Field operations are forced inline; the exponent chains, hash
// compression, decompression, encoding and the verify cores are
// __noinline__, so each
// is compiled once instead of once per call site (ptxas time grows fast
// with straight-line code of this size).
//
// The device functions in field.cuh, scalar.cuh, sha512.cuh, curve.cuh and
// the verify cores are plain C++ as well: without __CUDACC__ they compile
// as host inline functions, so their arithmetic can be checked by a host compiler
// against Python integers before it ever reaches the card.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TM_DEV __device__ __forceinline__
#define TM_NOINLINE __device__ __noinline__
#define TM_CONST __constant__
#define TM_UNROLL _Pragma("unroll")
#define TM_LDG(p) __ldg(p)
#else
#define TM_DEV static inline
#define TM_NOINLINE static
#define TM_CONST static const
#define TM_UNROLL
#define TM_LDG(p) (*(p))
#endif
