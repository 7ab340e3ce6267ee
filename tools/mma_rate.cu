// mma.sync rate on the card: how many cycles a warp spends per
// m16n8k16 bf16 mma (f32 accumulate), or with the argument tf32 per
// m16n8k8 tf32 mma, with 1, 2, 4 or 8 independent accumulators in flight,
// for 1-16 warps on each SM.  With one accumulator the figure is the mma's
// latency; with many warps and accumulators it approaches the tensor pipe's
// rate.  Sizes the designs of src/repro_torch/csrc/flash_attention.cu and
// mamba_scan_bwd.cu (how many independent mmas a warp must keep in flight).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_rate tools/mma_rate.cu
//   build/mma_rate [tf32]
#include <cuda_runtime.h>

#include <cstdio>

template <bool TF32>
__global__ void mma_loop(float* out, int iters, int indep) {
  float c[8][4] = {};
  const unsigned a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7, b0 = a0 + 1,
                 b1 = a0 + 2;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < indep) {
        if (TF32)
          asm volatile(
              "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
              : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
        else
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
              : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = (float)(t1 - t0);
  out[1 + threadIdx.x] = s;  // keeps the mmas live
}

int main(int argc, char** argv) {
  const bool tf32 = argc > 1 && argv[1][0] == 't';
  void (*loop)(float*, int, int) = tf32 ? mma_loop<true> : mma_loop<false>;
  float* d = nullptr;
  if (cudaMalloc(&d, 1024 * sizeof(float)) != cudaSuccess) return 1;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int iters = 4096;
  printf("%s\n", tf32 ? "m16n8k8 tf32" : "m16n8k16 bf16");
  for (int indep : {1, 2, 4, 8}) {
    for (int warps : {1, 2, 4, 8, 16}) {
      loop<<<sms, 32 * warps>>>(d, iters, indep);  // warm-up
      cudaEvent_t e0, e1;
      cudaEventCreate(&e0);
      cudaEventCreate(&e1);
      cudaEventRecord(e0);
      loop<<<sms, 32 * warps>>>(d, iters, indep);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0.f, cycles = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      cudaMemcpy(&cycles, d, sizeof(float), cudaMemcpyDeviceToHost);
      const double flops = (tf32 ? 2048.0 : 4096.0) * iters * indep * warps * sms;
      printf("independent=%d warps/SM=%2d: %.1f cycles per mma a warp, %.0f TFLOP/s\n", indep,
             warps, cycles / (iters * indep), flops / (ms * 1e-3) / 1e12);
    }
  }
  const cudaError_t st = cudaGetLastError();
  cudaFree(d);
  return st == cudaSuccess ? 0 : 1;
}
