"""Where the general GDN kernel's time goes, on the card.

Builds a copy of ``compression_tpu_torch/csrc/gdn.cu`` into
``compression_tpu_torch/csrc/build/`` with ``clock64`` counters around the
phases of one chunk of the mma.sync form, ``gdn_general_kernel`` (the first
half of its products, the stash of the next chunk, the issue of the loads
after it, the second half of the products, the barrier, the epilogue) and
of one K block of the TMA form, ``gdn_general_tma_kernel`` (the wait for
its stage, the A fragments' build, the arrival that marks the stage read,
the products' issue, the wait for the block before, the epilogue), summed
over CTA 0's first thread, and with two probes that issue nothing but
``mma.sync`` (m16n8k8 TF32 and m16n8k4 float64) from registers. Prints,
for 786,432 rows (16b's first GDN layer) of bfloat16 C = 192, float64
C = 256, float32 C = 318 (a width the TMA form does not take) and float32
C = 320 (the TMA form), the kernel's time and its clocks by phase, then
each probe's rate, beside the card's name and power limit.

    python3 tools/gdn_general_profile.py

Needs one NVIDIA H100 and nvcc. The counters cost the kernel some time:
compare the times here with chip_smoke.py's 16b, not with each other's
phases alone.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from compression_tpu_torch.util import cuda_build  # noqa: E402

PHASES = ("products1", "stash", "fetch", "products2", "barrier", "epilogue")
WIDE_PHASES = ("wait for the stage", "build A", "mark the stage read", "issue the products",
               "wait for the block before", "epilogue")
CLOCK = ('__device__ __forceinline__ unsigned long long clk() { unsigned long long t; '
         'asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)); return t; }\n')
# (anchor in gdn.cu, text that replaces it): counters around the phases.
HOOKS = [
    ("constexpr int kGenThreads",
     "__device__ unsigned long long g_prof[8];\n" + CLOCK + "constexpr int kGenThreads"),
    ("    A* cur = bufs + buf * R::kBuffer;\n",
     "    A* cur = bufs + buf * R::kBuffer;\n"
     "    const bool me = blockIdx.x == 0 && threadIdx.x == 0;\n"
     "    unsigned long long t0 = clk();\n"),
    ("    if (has_next) R::stash(staged, bufs + (buf ^ 1) * R::kBuffer);\n",
     "    unsigned long long t1 = clk();\n"
     "    if (has_next) R::stash(staged, bufs + (buf ^ 1) * R::kBuffer);\n"
     "    unsigned long long t2 = clk();\n"),
    ("    if (active) R::template products<R::kSteps / 2, R::kSteps>(acc, cur, wr, wc);\n"
     "    __syncthreads();\n",
     "    unsigned long long t3 = clk();\n"
     "    if (active) R::template products<R::kSteps / 2, R::kSteps>(acc, cur, wr, wc);\n"
     "    unsigned long long t4 = clk();\n"
     "    __syncthreads();\n"
     "    unsigned long long t5 = clk();\n"),
    ("      acc = typename R::Accum{};\n    }",
     "      acc = typename R::Accum{};\n    }\n"
     "    unsigned long long t6 = clk();\n"
     "    if (me) { g_prof[0] += t1 - t0; g_prof[1] += t2 - t1; g_prof[2] += t3 - t2;"
     " g_prof[3] += t4 - t3; g_prof[4] += t5 - t4; g_prof[5] += t6 - t5; g_prof[6] += 1; }"),
]
# The same for the TMA form, gdn_general_tma_kernel (hooked below its
# definition only): clocks a K block of warpgroup 0's first thread.
WIDE_HOOKS = [
    ("      const int slot = static_cast<int>(j % kWideStages);\n"
     "      mbar_wait(&bars[slot], static_cast<uint32_t>(j / kWideStages) & 1);\n",
     "      const bool me = blockIdx.x == 0 && threadIdx.x == 0;\n"
     "      unsigned long long t0 = clk();\n"
     "      const int slot = static_cast<int>(j % kWideStages);\n"
     "      mbar_wait(&bars[slot], static_cast<uint32_t>(j / kWideStages) & 1);\n"
     "      unsigned long long t1 = clk();\n"),
    ("      mbar_arrive(&frees[slot]);",
     "      unsigned long long t2 = clk();\n      mbar_arrive(&frees[slot]);"),
    ("      wgmma_fence();\n",
     "      unsigned long long t3 = clk();\n      wgmma_fence();\n"),
    ("      wgmma_commit();\n      wgmma_wait<1>();\n      ++j;\n",
     "      wgmma_commit();\n      unsigned long long t4 = clk();\n      wgmma_wait<1>();\n"
     "      if (me) { g_wide[0] += t1 - t0; g_wide[1] += t2 - t1; g_wide[2] += t3 - t2;"
     " g_wide[3] += t4 - t3; g_wide[4] += clk() - t4; g_wide[6] += 1; }\n      ++j;\n"),
    ("    wgmma_wait<0>();\n    fence_regs(big);\n",
     "    unsigned long long te = clk();\n    wgmma_wait<0>();\n    fence_regs(big);\n"),
    ("        *reinterpret_cast<float2*>(o + 8 * jj) = y;\n      }\n    }\n  }\n}\n",
     "        *reinterpret_cast<float2*>(o + 8 * jj) = y;\n      }\n    }\n"
     "    if (blockIdx.x == 0 && threadIdx.x == 0) g_wide[5] += clk() - te;\n  }\n}\n"),
]
PROBES = r'''
__global__ void tf32_probe(float* out, int iters) {
  float acc[16][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b[2] = {threadIdx.x * 3, threadIdx.x * 5};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 16; ++i) mma_tf32(acc[i], a, b);
  float s = 0;
  for (int i = 0; i < 16; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void f64_probe(double* out, int iters) {
  double acc[16][4] = {};
  const double a[2] = {threadIdx.x * 1.0, threadIdx.x * 2.0};
  const double b = threadIdx.x * 0.5;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 16; ++i) mma_f64(acc[i], a, b);
  double s = 0;
  for (int i = 0; i < 16; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int tpc_probe(void* out, int iters, int blocks, int threads, int f64) {
  if (f64) f64_probe<<<blocks, threads>>>(static_cast<double*>(out), iters);
  else tf32_probe<<<blocks, threads>>>(static_cast<float*>(out), iters);
  return cudaGetLastError();
}
extern "C" int tpc_prof(unsigned long long* host, int reset) {
  const unsigned long long zero[8] = {};
  if (reset) {
    cudaMemcpyToSymbol(g_wide, zero, sizeof(zero));
    return cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  }
  cudaMemcpyFromSymbol(host + 8, g_wide, sizeof(g_wide));
  return cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
}
'''
DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3}


def build() -> ctypes.CDLL:
    src = (cuda_build.CSRC / "gdn.cu").read_text()
    cut = src.index("gdn_general_tma_kernel(const")
    head, wide = src[:cut], src[cut:]
    for part, hooks in ((0, HOOKS), (1, WIDE_HOOKS)):
        for anchor, text in hooks:
            code = wide if part else head
            if anchor not in code:
                raise SystemExit(f"gdn.cu changed: no {anchor!r} to hook")
            if part:
                wide = wide.replace(anchor, text, 1)
            else:
                head = head.replace(anchor, text, 1)
    src = head.replace("constexpr int kGenThreads",
                       "__device__ unsigned long long g_wide[8];\nconstexpr int kGenThreads", 1) + wide
    out = cuda_build.CSRC / "build"
    out.mkdir(exist_ok=True)
    path = out / "gdn_profile.cu"
    path.write_text(src + PROBES)
    lib_path = out / "libgdn_profile.so"
    res = subprocess.run([cuda_build._nvcc(), cuda_build.ARCH, "-std=c++17", "-O3", "-shared",
                          "-Xcompiler", "-fPIC", str(path), "-o", str(lib_path)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(res.stderr[-4000:])
    lib = ctypes.CDLL(str(lib_path))
    lib.tpc_gdn_general_forward.restype = ctypes.c_int
    lib.tpc_gdn_general_forward.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.tpc_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tpc_probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    return lib


def event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    if not torch.cuda.is_available():
        print("gdn_general_profile: needs the card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    lib = build()
    rows = 786_432
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c, dtype, inverse in ((192, torch.bfloat16, 0), (256, torch.float64, 1),
                              (318, torch.float32, 1), (320, torch.float32, 1)):
        x = torch.randn(rows, c, device="cuda", generator=gen).to(dtype)
        beta = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(dtype)
        gamma = (torch.rand(c, c, device="cuda", generator=gen) * 0.1 / c
                 + 0.05 * torch.eye(c, device="cuda")).to(dtype)
        out = torch.empty_like(x)

        def call():
            rc = lib.tpc_gdn_general_forward(
                x.data_ptr(), beta.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows, c,
                inverse, DTYPES[dtype], torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        call()
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * 16)()
        lib.tpc_prof(counts, 1)
        ms = event_ms(call)
        lib.tpc_prof(counts, 0)
        wide = counts[14] > 0  # the TMA form ran
        at, names, unit = (8, WIDE_PHASES, "K block") if wide else (0, PHASES, "chunk")
        chunks, total = max(counts[at + 6], 1), sum(counts[at:at + 6])
        print(f"{str(dtype).split('.')[-1]} C={c} {'inverse' if inverse else 'forward'} "
              f"({'gdn_general_tma_kernel' if wide else 'gdn_general_kernel'}): "
              f"{ms:.3f} ms with counters; CTA 0: {chunks} {unit}s, {total / chunks:.0f} clocks "
              f"a {unit}: " + ", ".join(
                  f"{name} {counts[at + i] / chunks:.0f} ({100 * counts[at + i] / total:.0f}%)"
                  for i, name in enumerate(names)))
    sink = torch.empty(132 * 2 * 128, device="cuda", dtype=torch.float64)
    for f64, name, k in ((0, "mma.sync m16n8k8 tf32", 8), (1, "mma.sync m16n8k4 f64", 4)):
        for blocks in (132, 264):
            lib.tpc_probe(sink.data_ptr(), 10, blocks, 128, f64)
            torch.cuda.synchronize()
            iters = 2000
            ms = event_ms(lambda: lib.tpc_probe(sink.data_ptr(), iters, blocks, 128, f64))
            flop = blocks * 4 * iters * 16 * 2 * 16 * 8 * k
            print(f"{name}, {blocks} CTAs of 4 warps: {ms:.3f} ms, {flop / ms / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
