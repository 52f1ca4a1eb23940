// The emulation's globals (emu_cuda.h).
#include "emu_cuda.h"
namespace emu { Block* cur; thread_local unsigned tid; }
thread_local uint3 threadIdx;
uint3 blockIdx;
dim3 gridDim, blockDim;
