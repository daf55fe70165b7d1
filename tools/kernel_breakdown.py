#!/usr/bin/env python3
"""Where the device time of K4 (the fused Mehrotra iteration) and K1 (the
rollout with its Jacobian) goes, on one CUDA card.

    python3 tools/kernel_breakdown.py              # this checkout's kernels
    python3 tools/kernel_breakdown.py --tree DIR   # another checkout's, e.g.
                                                   # a `git archive` of a parent

Everything is built into build/breakdown/ from text-patched copies of the
tree's own `tum_control_tpu_torch/csrc` sources; the package is not touched.
On chip_smoke.py's inputs (B = 128; the nominal QP's first iteration; K1 at
the nominal and SNMPC element counts) it prints:
  * K4's device time, and the cycles of each phase per block (thread 0's
    clock64() between the phases, averaged over the blocks) in a stamped
    copy timed beside it. It recognises both designs of K4: the one-warp
    substitution of `trisolve.cuh` and the blocked substitution of
    `ipm_iter.cu::warp_solve_blocked`;
  * for the blocked design, K4 with the chain's quotient x * (1 / L_jj) in
    place of div_rn, and K4 without its substitutions (wrong results, for
    the time they take);
  * K1 with 1, 2 or 5 tangents per thread under a few launch bounds, and
    each variant's worst J column against the plain version; and the
    primal alone (no tangents, one thread per element): the latency of one
    thread's chain of model evaluations.
Device times as chip_smoke.device_ms takes them (100 launches behind a
sleep). The `[sass]` lines count instructions of each built kernel by kind.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "breakdown")
NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NST = 24  # stamps per block

STAMPS = (
    f"\n__device__ long long g_st[256 * {NST}];\n"
    f"#define ST(k) do {{ if (threadIdx.x == 0) g_st[blockIdx.x * {NST} + (k)] = clock64(); }} while (0)\n"
    "#define STG(k) do { if (threadIdx.x == 0) { long long g_; asm volatile(\"mov.u64 %0, %%globaltimer;\""
    f" : \"=l\"(g_)); g_st[blockIdx.x * {NST} + (k)] = g_; }} }} while (0)\n"
    "extern \"C\" int k4_stamps(long long* h) {"
    " return (int)cudaMemcpyFromSymbol(h, g_st, sizeof(g_st)); }\n"
)

# (anchor, replacement) text patches that put stamps between K4's phases;
# stamp 20 / 21 are the globaltimer at the block's start and end
BLOCKED_PATCHES = [
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  STG(20); ST(0);\n"),
    ("  cp_async_wait_all();\n  __syncthreads();  // sL, sG staged\n",
     "  ST(1);\n  cp_async_wait_all();\n  __syncthreads();  // sL, sG staged\n"),
    ("  // this thread's share of G^T y", "  ST(2);\n  // this thread's share of G^T y"),
    ("    if (row) sy[tid] = chat_u - chat_l;\n    __syncthreads();\n",
     "    if (row) sy[tid] = chat_u - chat_l;\n    __syncthreads();\n    ST(3 + 5 * pass);\n"),
    ("      reinterpret_cast<float4*>(spart + part * npad)[q] = acc;\n    }\n    __syncthreads();\n",
     "      reinterpret_cast<float4*>(spart + part * npad)[q] = acc;\n    }\n    __syncthreads();\n"
     "    ST(4 + 5 * pass);\n"),
    ("      warp_solve_blocked(sL, ld, npad, sdt, sinv, sx, lane);\n    }\n    __syncthreads();\n",
     "      warp_solve_blocked(sL, ld, npad, sdt, sinv, sx, lane);\n    }\n    __syncthreads();\n"
     "    ST(5 + 5 * pass);\n"),
    ("    dlu = act_u ? chat_u + sig_u * gdw : 0.0f;\n",
     "    ST(6 + 5 * pass);\n    dlu = act_u ? chat_u + sig_u * gdw : 0.0f;\n"),
    ("      alpha = pmin(1.0f, gamma_ftb * r2.y);\n    }\n",
     "      alpha = pmin(1.0f, gamma_ftb * r2.y);\n    }\n    ST(7 + 5 * pass);\n"),
    ("  if (tid == 0) unc_out[b] = unconverged ? 1 : 0;\n}",
     "  if (tid == 0) unc_out[b] = unconverged ? 1 : 0;\n  ST(13); STG(21);\n}"),
]
BLOCKED_PHASES = [
    (0, 1, "row loads, barrier terms (L, G copies in flight)"),
    (1, 2, "wait for the copies, 1 / L_jj, transposed blocks"),
    (2, 3, "affine: chat, y, sync"), (3, 4, "affine: G^T y slices + sync"),
    (4, 5, "affine: rhs + substitution (warp 0) + sync"), (5, 6, "affine: G dw"),
    (6, 7, "affine: directions, step, gap (2 reductions)"),
    (7, 8, "centred: chat, y, sync"), (8, 9, "centred: G^T y slices + sync"),
    (9, 10, "centred: rhs + substitution (warp 0) + sync"), (10, 11, "centred: G dw"),
    (11, 12, "centred: directions, step, isfinite (1 reduction)"),
    (12, 13, "update, stores, next sigma"),
]
# the one-warp design (trisolve.cuh): `directions` is a lambda run twice
ONE_WARP_PATCHES = [
    ("  extern __shared__ float sm[];\n", "  extern __shared__ float sm[];\n  STG(20); ST(0);\n"),
    ("  __syncthreads();  // sL, sG staged\n", "  ST(1);\n  __syncthreads();  // sL, sG staged\n  ST(2);\n"),
    ("  auto directions = [&](float tau) {", "  int sbase = 3;\n  auto directions = [&](float tau) {"),
    ("    if (row) sy[tid] = chat_u - chat_l;\n    __syncthreads();\n",
     "    if (row) sy[tid] = chat_u - chat_l;\n    __syncthreads();\n    ST(sbase);\n"),
    ("      sx[tid] = rwz + (t + sy[ncg + tid]);\n    }\n    __syncthreads();\n",
     "      sx[tid] = rwz + (t + sy[ncg + tid]);\n    }\n    __syncthreads();\n    ST(sbase + 1);\n"),
    ("    __syncthreads();\n    d.dw = vz ? sx[tid] : 0.0f;",
     "    __syncthreads();\n    ST(sbase + 2);\n    d.dw = vz ? sx[tid] : 0.0f;"),
    ("    d.gdw = gdw;\n", "    d.gdw = gdw;\n    ST(sbase + 3);\n"),
    ("    d.alpha = pmin(1.0f, gamma_ftb * block_min(step, red));\n    return d;",
     "    d.alpha = pmin(1.0f, gamma_ftb * block_min(step, red));\n    ST(sbase + 4);\n"
     "    sbase += 5;\n    return d;"),
    ("  const float ratio_gap = gap_aff / pmax(gap, 1e-30f);",
     "  ST(13);\n  const float ratio_gap = gap_aff / pmax(gap, 1e-30f);"),
    ("  const bool ok = unconverged && finite_dw && isfinite(d.alpha);",
     "  ST(19);\n  const bool ok = unconverged && finite_dw && isfinite(d.alpha);"),
    ("  if (tid == 0) unc_out[b] = unconverged ? 1 : 0;\n}",
     "  if (tid == 0) unc_out[b] = unconverged ? 1 : 0;\n  ST(22); STG(21);\n}"),
]
ONE_WARP_PHASES = [
    (0, 1, "stage L, G, row loads, barrier terms"), (1, 2, "sync"),
    (2, 3, "affine: chat, y, sync"), (3, 4, "affine: G^T y + sync"),
    (4, 5, "affine: one-warp substitution + sync"), (5, 6, "affine: G dw, directions"),
    (6, 7, "affine: step min"), (7, 13, "gap_aff, sigma"),
    (13, 8, "centred: chat, y, sync"), (8, 9, "centred: G^T y + sync"),
    (9, 10, "centred: one-warp substitution + sync"), (10, 11, "centred: G dw, directions"),
    (11, 12, "centred: step min"), (12, 19, "isfinite"), (19, 22, "update, stores, next sigma"),
]


def say(*a):
    print(*a, flush=True)


def patched(text, patches):
    for a, b in patches:
        if text.count(a) != 1:
            raise RuntimeError(f"patch anchor not found once: {a[:70]!r}")
        text = text.replace(a, b)
    return text


def sass_counts(so, tag):
    """Instructions of each kernel in `so` by kind (cuobjdump -sass)."""
    dump = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", so], capture_output=True,
                          text=True).stdout
    for f in re.split(r"\n\s*Function : ", dump)[1:]:
        ops = [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0]
               for i in re.findall(r"/\*[0-9a-f]{4,6}\*/\s+([^;]*);", f) if i.strip()]
        cnt = {}
        for o in ops:
            cnt[o.split(".")[0]] = cnt.get(o.split(".")[0], 0) + 1
        keys = ("LDL", "STL", "MUFU", "CALL", "FCHK", "BAR", "SHFL", "LDS", "LDGSTS", "FFMA", "BRA")
        say(f"[sass] {tag}: {len(ops)} instructions; " + ", ".join(f"{k} {cnt.get(k, 0)}" for k in keys))


def build(sources):
    """{tag: cuda source text} -> {tag: loaded library}, one nvcc each, in parallel."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for tag, text in sources.items():
        cu, so = os.path.join(OUT, f"{tag}.cu"), os.path.join(OUT, f"lib{tag}.so")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[tag] = (subprocess.Popen([NVCC, *NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for tag, (p, so) in procs.items():
        log, _ = p.communicate()
        regs = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l or "error" in l]
        say(f"[build] {tag}: rc {p.returncode}; " + " | ".join(regs)[:300])
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log[-3000:]}")
        sass_counts(so, tag)
        libs[tag] = ctypes.CDLL(so)
    return libs


def k4(tree, dev, device_ms):
    from chip_smoke import B, NZ, NCG, ipm_start, k4_args, random_qp
    from tum_control_tpu_torch.ops.kernels.ipm_iter import fused_iteration_cuda, iteration_ref
    csrc = os.path.join(tree, "tum_control_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "ipm_iter.cu")).read()
    src = src.replace('#include "', f'#include "{csrc}/')
    blocked = "warp_solve_blocked" in src
    inc = src[src.index(f'#include "{csrc}/common.cuh"'):].split("\n", 1)[0]
    stamped = patched(src.replace(inc, inc + STAMPS, 1),
                      BLOCKED_PATCHES if blocked else ONE_WARP_PATCHES)
    sources = {"k4_stamped": stamped}
    if blocked:
        mul = src.replace("v[j] = div_rn(v[j], c[j], iv[j]);", "v[j] = v[j] * iv[j];").replace(
            "v[j] = div_rn(v[j], r[j], iv[j]);", "v[j] = v[j] * iv[j];")
        sources["k4_recip_chain"] = mul
        sources["k4_no_substitution"] = patched(
            src, [("      warp_solve_blocked(sL, ld, npad, sdt, sinv, sx, lane);\n", "")])
    libs = build(sources)

    qp = random_qp(np.random.default_rng(0), dev, B)
    carry, nt, H = ipm_start(qp)
    L = torch.tensor(np.linalg.cholesky(H.double().cpu().numpy()), dtype=torch.float32, device=dev)
    args = k4_args(qp, carry, nt, L)
    pc, _, _ = iteration_ref(*args, carry)
    outs = [torch.empty_like(x) for x in carry] + [torch.empty_like(carry[1])]
    unc = torch.empty((B,), dtype=torch.bool, device=dev)
    inp = (ctypes.c_void_p * 19)(*[t.data_ptr() for t in args + tuple(carry)])
    outp = (ctypes.c_void_p * 11)(*[t.data_ptr() for t in outs])
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    say(f"[K4] {'blocked' if blocked else 'one-warp'} design: kernel "
        f"{device_ms(lambda: fused_iteration_cuda(*args, carry)):.5f} ms device")
    for tag, lib in libs.items():
        fn = lib.ipm_iteration_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]

        def go(fn=fn):
            status = fn(ctypes.cast(inp, ctypes.c_void_p), ctypes.cast(outp, ctypes.c_void_p),
                        unc.data_ptr(), B, NZ, NCG, 0.99, stream)
            if status != 0:
                raise RuntimeError(f"{tag}: cudaError {status}")
        go()
        torch.cuda.synchronize()
        err = float((outs[0] - pc[0]).abs().max() / pc[0].abs().max())
        say(f"[K4] {tag}: {device_ms(go):.5f} ms device; w {err:.2e} of max |plain| from the plain "
            "version")
    fn = libs["k4_stamped"].ipm_iteration_f32
    fn(ctypes.cast(inp, ctypes.c_void_p), ctypes.cast(outp, ctypes.c_void_p), unc.data_ptr(),
       B, NZ, NCG, 0.99, stream)
    torch.cuda.synchronize()
    st = np.zeros(256 * NST, np.int64)
    libs["k4_stamped"].k4_stamps(st.ctypes.data_as(ctypes.c_void_p))
    s = st.reshape(256, NST)[:B].astype(float)
    phases = BLOCKED_PHASES if blocked else ONE_WARP_PHASES
    end = phases[-1][1]
    tot, ns = s[:, end] - s[:, 0], s[:, 21] - s[:, 20]
    say(f"[K4 stamps] per block {tot.mean():.0f} cycles (min {tot.min():.0f}, max {tot.max():.0f}),"
        f" {ns.mean():.0f} ns -> {np.mean(tot / ns):.3f} GHz")
    for a, b, name in phases:
        d = s[:, b] - s[:, a]
        say(f"[K4 stamps] {name:52s} {d.mean():8.0f} cycles (max {d.max():8.0f}) "
            f"{d.mean() / tot.mean():.3f}")


# K1's primal alone, one thread per element, appended to a copy of
# linearize.cu (it unpacks the parameters as linearize_f32 does)
PRIMAL = """
__global__ void lin_primal_kernel(const float* __restrict__ xu, float* __restrict__ F, int n_el,
                                  ModelParams p, int n_sub, float h, float h2, float h6) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_el) return;
  float x[8], u[2];
  for (int v = 0; v < 10; ++v) {
    if (v < 8) x[v] = xu[(long)e * 10 + v]; else u[v - 8] = xu[(long)e * 10 + v];
  }
  rk4_pred(x, u, n_sub, h, h2, h6, p);
  for (int i = 0; i < 8; ++i) F[(long)e * 8 + i] = x[i];
}
extern "C" int linearize_primal_f32(const float* xu, float* F, int n_el, const double* prm,
                                    int n_sub, void* stream) {
  ModelParams p;
  float* dst = reinterpret_cast<float*>(&p);
  const int np = sizeof(ModelParams) / sizeof(float);
  for (int i = 0; i < np; ++i) dst[i] = (float)prm[i];
  lin_primal_kernel<<<(n_el + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      xu, F, n_el, p, n_sub, (float)prm[np], (float)prm[np + 1], (float)prm[np + 2]);
  return (int)cudaGetLastError();
}
"""


def k1(tree, dev, device_ms):
    from chip_smoke import B, N, NU, NX
    from tum_control_tpu_torch.api import build_controller
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.ops.kernels.linearize import linearize_cuda, linearize_ref
    csrc = os.path.join(tree, "tum_control_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "linearize.cu")).read().replace('#include "', f'#include "{csrc}/')
    sources = {}
    if "LIN_ND" in src:
        for nd, mb in ((1, 6), (1, 7), (2, 3), (2, 4), (2, 5), (5, 2)):
            sources[f"k1_nd{nd}_mb{mb}"] = patched(src, [
                (re.search(r"constexpr int LIN_ND = \d+;", src).group(0), f"constexpr int LIN_ND = {nd};"),
                (re.search(r"constexpr int LIN_MIN_BLOCKS = \d+;", src).group(0),
                 f"constexpr int LIN_MIN_BLOCKS = {mb};")])
    else:
        for nd in (1, 2, 5):
            sources[f"k1_nd{nd}"] = patched(src, [("constexpr int ND = 1;", f"constexpr int ND = {nd};")])
    sources["k1_primal_only"] = src + PRIMAL
    libs = build(sources)
    ctrl = build_controller(MPCConfig(), SimConfig(), device=dev)
    sctrl = build_controller(MPCConfig(controller="snmpc"), SimConfig(), device=dev)
    rng = np.random.default_rng(3)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for case, n_per, rl in (("nominal", N, ctrl.engine.funcs.lin_rollout), ("snmpc", 88, sctrl.lin_roll8)):
        XU = np.concatenate([rng.uniform(-50, 50, (B, n_per, 2)), rng.uniform(0, 6.2, (B, n_per, 1)),
                             rng.uniform(5.0, 30, (B, n_per, 1)), rng.normal(0, 0.3, (B, n_per, 4)),
                             rng.normal(0, 1, (B, n_per, 2)) * [1.0, 0.1]], axis=2)
        XU = torch.tensor(XU, dtype=torch.float32, device=dev)
        _, Jp = linearize_ref(XU, rl.step, NX)
        say(f"[K1 {case}] kernel {device_ms(lambda: linearize_cuda(XU, rl.prm, rl.n_sub)):.5f} ms "
            f"device ({B * n_per} elements, {rl.n_sub} RK4 substep(s))")
        F = torch.empty(B, n_per, NX, device=dev)
        J = torch.empty(B, n_per, NX, NX + NU, device=dev)
        fp = libs["k1_primal_only"].linearize_primal_f32
        fp.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_void_p]
        prim = lambda: fp(XU.data_ptr(), F.data_ptr(), B * n_per, ctypes.cast(rl.prm, ctypes.c_void_p),
                          rl.n_sub, stream)
        say(f"[K1 {case}] primal only, one thread per element: {device_ms(prim):.5f} ms device")
        for tag, lib in libs.items():
            if tag == "k1_primal_only":
                continue
            fn = lib.linearize_f32
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                                   ctypes.c_void_p]

            def go(fn=fn):
                status = fn(XU.data_ptr(), F.data_ptr(), J.data_ptr(), B * n_per,
                            ctypes.cast(rl.prm, ctypes.c_void_p), rl.n_sub, stream)
                if status != 0:
                    raise RuntimeError(f"{tag}: cudaError {status}")
            go()
            torch.cuda.synchronize()
            err = max(float((J[..., c] - Jp[..., c]).abs().max() / Jp[..., c].abs().max())
                      for c in range(NX + NU))
            say(f"[K1 {case}] {tag}: {device_ms(go):.5f} ms device; worst J column {err:.2e} of "
                "its max |plain|")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=REPO, help="checkout whose kernels to take apart")
    tree = os.path.abspath(ap.parse_args().tree)
    if not torch.cuda.is_available():
        print("no CUDA device: the breakdown runs on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, tree)   # the tree's package
    # chip_smoke's inputs and timing from this checkout, whatever the tree holds
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    sys.modules["chip_smoke"] = chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    device_ms = chip_smoke.device_ms
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    say(f"{smi} | tree {tree}")
    dev = torch.device("cuda", 0)
    k4(tree, dev, device_ms)
    k1(tree, dev, device_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
