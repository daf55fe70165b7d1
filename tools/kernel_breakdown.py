#!/usr/bin/env python3
"""Where the device time of K2 / K6 (condensing), K5 / the K7 solve (the
triangular solve), K4 (the fused Mehrotra iteration) and K1 (the rollout
with its Jacobian) goes, on one CUDA card.

    python3 tools/kernel_breakdown.py              # this checkout's kernels
    python3 tools/kernel_breakdown.py --tree DIR   # another checkout's, e.g.
                                                   # a `git archive` of a parent
    python3 tools/kernel_breakdown.py --sections condense,solve   # some of them

Everything is built into build/breakdown/ from text-patched copies of the
tree's own `tum_control_tpu_torch/csrc` sources; the package is not touched.
On chip_smoke.py's shapes (B = 128; K2 at N = 38, nx = 8, nu = 2; K6 on
SNMPC's 33-stage tail from a dense carry; K5 and the K7 solve at n = 76; the
nominal QP's first iteration; K1 at the nominal and SNMPC element counts)
it prints:
  * `condense`: K2's and K6's device time, a fill of the same Gamma
    (Tensor.zero_) as a yardstick of its write, and the cycles of each
    phase per block, summed over the stages by two threads (averaged over
    the blocks) in a stamped copy timed beside it: staging, the Gam
    products, e, the barrier wait and the stores of the one-block-per-
    scenario design; staging, the products, B / xi and the stores of the
    column design, with its variants (no stores; 3 warps a block);
  * `solve`: K5's and the K7 solve's device time, and their phases
    (staging; forward substitution; backward substitution; stores) per
    block, for the one-warp and the blocked substitution;
  * `k4`: K4's device time, and the cycles of each phase per block (thread
    0's clock64() between the phases, averaged over the blocks) in a
    stamped copy timed beside it, for the one-warp substitution and the
    blocked one (in `ipm_iter.cu` or, shared with K5, `trisolve.cuh`);
    for the blocked design, K4 with the chain's quotient x * (1 / L_jj) in
    place of div_rn, and K4 without its substitutions (wrong results, for
    the time they take);
  * `k1`: K1 with 1, 2 or 5 tangents per thread under a few launch bounds, and
    each variant's worst J column against the plain version; and the
    primal alone (no tangents, one thread per element): the latency of one
    thread's chain of model evaluations.
Device times as chip_smoke.device_ms takes them (100 launches behind a
sleep). The `[sass]` lines count instructions of each built kernel by kind,
the tree's own libraries (`[sass] lib...`) and the stamped copies. Each
section recognises the parent's design and this tree's (see the patch lists).
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

MAX_BLOCKS = 1024
STAMPS = (
    f"\n__device__ long long g_st[{MAX_BLOCKS} * {NST}];\n"
    f"__device__ long long g_acc[{MAX_BLOCKS} * 2 * 8];\n"
    "#define BID_ (blockIdx.y * gridDim.x + blockIdx.x)\n"
    f"#define ST(k) do {{ if (threadIdx.x == 0) g_st[BID_ * {NST} + (k)] = clock64(); }} while (0)\n"
    "#define STG(k) do { if (threadIdx.x == 0) { long long g_; asm volatile(\"mov.u64 %0, %%globaltimer;\""
    f" : \"=l\"(g_)); g_st[BID_ * {NST} + (k)] = g_; }} }} while (0)\n"
    # per-thread cycles of up to 8 phases, summed over a loop; ACC_SAVE(t0, t1)
    # keeps those of threads t0 and t1
    "#define ACC_INIT long long acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0}; long long last_ = clock64()\n"
    "#define ACC(k) do { const long long n_ = clock64(); acc_[k] += n_ - last_; last_ = n_; } while (0)\n"
    "#define ACC_SAVE(t0, t1) do { if (threadIdx.x == (t0) || threadIdx.x == (t1)) {"
    " const int s_ = threadIdx.x == (t0) ? 0 : 1;"
    " for (int q_ = 0; q_ < 8; ++q_) g_acc[(BID_ * 2 + s_) * 8 + q_] = acc_[q_]; } } while (0)\n"
    "extern \"C\" int bd_stamps(long long* h) {"
    " return (int)cudaMemcpyFromSymbol(h, g_st, sizeof(g_st)); }\n"
    "extern \"C\" int bd_acc(long long* h) {"
    " return (int)cudaMemcpyFromSymbol(h, g_acc, sizeof(g_acc)); }\n"
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


# K2 / K6, the one-block-per-scenario design (one thread per Gam entry, a
# block barrier per stage): cycles per phase, summed over the stages by
# thread 0 (warp 0, which also computes e) and thread 32 (warp 1, no e)
K2_BARRIER_PATCHES = [
    ("  const int tid = threadIdx.x, bs = blockDim.x;\n",
     "  const int tid = threadIdx.x, bs = blockDim.x;\n  STG(20); ACC_INIT;\n"),
    ("  for (int i = tid; i < nx; i += bs) e[0][i] = e0[(long)b * nx + i];\n  __syncthreads();\n",
     "  for (int i = tid; i < nx; i += bs) e[0][i] = e0[(long)b * nx + i];\n  __syncthreads();\n"
     "  ACC(0);\n"),
    ("    for (int i = tid; i < nx; i += bs) eo[k * nx + i] = ec[i];\n",
     "    for (int i = tid; i < nx; i += bs) eo[k * nx + i] = ec[i];\n    ACC(1);\n"),
    ("      gn[idx] = acc;\n    }\n", "      gn[idx] = acc;\n    }\n    ACC(2);\n"),
    ("      en[i] = acc + sxi[k * nx + i];\n    }\n",
     "      en[i] = acc + sxi[k * nx + i];\n    }\n    ACC(3);\n"),
    ("    __syncthreads();\n  }\n}\n",
     "    __syncthreads();\n    ACC(4);\n  }\n  ACC_SAVE(0, 32); STG(21);\n}\n"),
]
K2_BARRIER_PHASES = ["staging A, B, xi, carry (synchronous loads) + barrier",
                     "stores of Gam_k, e_k (all stages)", "Gam products (idx / nz, nx FMAs)",
                     "e (threads 0 .. nx-1; others pass)", "barrier wait"]
K2_BARRIER_THREADS = ("thread 0 (warp 0: Gam and e)", "thread 32 (warp 1: Gam only)")

# K2 / K6, the column design (one thread per column of Gam or e, the column
# in registers, no barrier per stage): cycles per phase, summed over the
# stages by lanes 0 and 12 of every block (lane 12 of the last block holds e
# at nz = 76)
K2_COLUMN_PATCHES = [
    ("  const int z = (blockIdx.x - b * s.blocks) * COND_THREADS + t;\n",
     "  const int z = (blockIdx.x - b * s.blocks) * COND_THREADS + t;\n  STG(20); ACC_INIT;\n"),
    ("  for (int i = 0; i < R; ++i) bz[i] = (kz >= 0 && i < nx) ? sB[(kz * nx + i) * nu + qz] : 0.0f;\n",
     "  for (int i = 0; i < R; ++i) bz[i] = (kz >= 0 && i < nx) ? sB[(kz * nx + i) * nu + qz] : 0.0f;\n"
     "  ACC(0);\n"),
    ("    stage_product<NX>(cur, sA + k * nx * nx, nx, g, gn);\n",
     "    stage_product<NX>(cur, sA + k * nx * nx, nx, g, gn);\n    ACC(1);\n"),
    ("      g[i] = gn[i];\n    }\n    store(k + 1);\n  };\n",
     "      g[i] = gn[i];\n    }\n    ACC(2);\n    store(k + 1);\n    ACC(3);\n  };\n"),
    ("    if (k + 1 < N) step(k + 1, a1, a0, x1, x0);\n  }\n}\n",
     "    if (k + 1 < N) step(k + 1, a1, a0, x1, x0);\n  }\n  ACC_SAVE(0, 12); STG(21);\n}\n"),
]
K2_COLUMN_PHASES = ["stage A, B, xi (cp.async), load the carry, store stage 0, wait, B column",
                    "A_{k+1}, xi_{k+1} loads + A_k Gam_k products (all stages)",
                    "B / xi select and add", "stores (all stages)"]
K2_COLUMN_THREADS = ("lane 0 of every block", "lane 12 of every block (e in the last)")
# column-design variants timed beside it: no stores but the last stage's (the
# work without its output); 96 columns (3 warps) a block, one block per
# scenario at nz = 76, A, B, xi staged once per scenario
K2_COLUMN_VARIANTS = {
    "k2_no_stores": [("    store(k + 1);\n  };\n", "    if (k + 1 == N) store(k + 1);\n  };\n")],
    "k2_three_warps_per_block": [("constexpr int COND_THREADS = 32;", "constexpr int COND_THREADS = 96;")],
}

# K5 / the K7 solve, the blocked design (trisolve.cuh::warp_solve_blocked,
# shared with K4): stamps of thread 0 (warp 0 runs the substitution)
K5_BLOCKED_PATCHES = [
    ("  const float* Lb = L + (size_t)blockIdx.x * n * n;\n",
     "  const float* Lb = L + (size_t)blockIdx.x * n * n;\n  STG(20); ST(0);\n"),
    ("  cp_async_wait_all();\n  __syncthreads();\n  solve_prep<SOLVE_THREADS>(sL, ld, npad, sdt, sinv, tid);\n"
     "  __syncthreads();\n",
     "  ST(1);\n  cp_async_wait_all();\n  __syncthreads();\n  ST(2);\n"
     "  solve_prep<SOLVE_THREADS>(sL, ld, npad, sdt, sinv, tid);\n  __syncthreads();\n  ST(3);\n"),
    ("  warp_solve_blocked<RECIP>(sL, ld, npad, sdt, sinv, sx, lane);\n"
     "  for (int i = lane; i < n; i += 32) x[(size_t)blockIdx.x * n + i] = sx[i];\n}\n",
     "  warp_solve_blocked<RECIP>(sL, ld, npad, sdt, sinv, sx, lane);\n  ST(5);\n"
     "  for (int i = lane; i < n; i += 32) x[(size_t)blockIdx.x * n + i] = sx[i];\n"
     "  ST(6); STG(21);\n}\n"),
]
K5_BLOCKED_HEADERS = {"trisolve.cuh": [("  // backward: L^T x = y\n",
                                        "  ST(4);\n  // backward: L^T x = y\n")]}
K5_BLOCKED_PHASES = [
    (0, 1, "issue the copies of L's lower triangle and b, identity tail"),
    (1, 2, "wait for the copies + barrier"), (2, 3, "1 / L_jj, transposed blocks + barrier"),
    (3, 4, "forward substitution (warp 0, 16-row blocks)"),
    (4, 5, "backward substitution (warp 0, 16-row blocks)"), (5, 6, "store x"),
]

# K5 / the K7 solve, the one-warp design (trisolve.cuh::warp_chol_solve):
# stamps of thread 0 (warp 0 runs the substitution)
K5_ONE_WARP_PATCHES = [
    ("  const int ld = n + 1;\n  const int tid = threadIdx.x;\n",
     "  const int ld = n + 1;\n  const int tid = threadIdx.x;\n  STG(20); ST(0);\n"),
    ("  __syncthreads();\n  if (tid >= 32) return;\n",
     "  __syncthreads();\n  ST(1);\n  if (tid >= 32) return;\n"),
    ("  warp_chol_solve<MAXR, RECIP>(sl, ld, n, xr);\n",
     "  ST(2);\n  warp_chol_solve<MAXR, RECIP>(sl, ld, n, xr);\n  ST(4);\n"),
    ("    if (i < n) x[(long)blockIdx.x * n + i] = xr[r];\n  }\n}\n",
     "    if (i < n) x[(long)blockIdx.x * n + i] = xr[r];\n  }\n  ST(5); STG(21);\n}\n"),
]
K5_ONE_WARP_HEADERS = {"trisolve.cuh": [("  // backward: L^T x = y\n",
                                         "  ST(3);\n  // backward: L^T x = y\n")]}
K5_ONE_WARP_PHASES = [
    (0, 1, "stage all n^2 of L (synchronous, idx / n) + barrier"), (1, 2, "load b"),
    (2, 3, "forward substitution (one warp, n steps)"),
    (3, 4, "backward substitution (one warp, n steps)"), (4, 5, "store x"),
]


def say(*a):
    print(*a, flush=True)


def patched(text, patches):
    for a, b in patches:
        if text.count(a) != 1:
            raise RuntimeError(f"patch anchor not found once: {a[:70]!r}")
        text = text.replace(a, b)
    return text


def csrc_text(tree, name, patches=(), headers=None):
    """csrc/<name> of `tree` with `patches` applied, each header in `headers`
    ({file: patches}) inlined with its own patches, the other includes made
    absolute, and the stamp macros (STAMPS) in front."""
    csrc = os.path.join(tree, "tum_control_tpu_torch", "csrc")
    src = patched(open(os.path.join(csrc, name)).read(), patches)
    for h, hp in (headers or {}).items():
        text = open(os.path.join(csrc, h)).read().replace("#pragma once\n", "")
        src = patched(src, [(f'#include "{h}"\n', patched(text, hp) + "\n")])
    return "#include <cuda_runtime.h>\n" + STAMPS + src.replace('#include "', f'#include "{csrc}/')


def read_stamps(lib):
    """The stamped copy's clock64() / globaltimer stamps, (MAX_BLOCKS, NST)."""
    st = np.zeros(MAX_BLOCKS * NST, np.int64)
    lib.bd_stamps(st.ctypes.data_as(ctypes.c_void_p))
    return st.reshape(MAX_BLOCKS, NST).astype(float)


def read_acc(lib):
    """The stamped copy's per-phase cycles of its two saved threads,
    (MAX_BLOCKS, 2, 8)."""
    acc = np.zeros(MAX_BLOCKS * 16, np.int64)
    lib.bd_acc(acc.ctypes.data_as(ctypes.c_void_p))
    return acc.reshape(MAX_BLOCKS, 2, 8).astype(float)


def say_phases(tag, s, phases):
    """Cycles of each (start stamp, end stamp, name) phase, averaged over the
    blocks (rows of s); stamps 20 / 21 are the globaltimer."""
    end = phases[-1][1]
    tot, ns = s[:, end] - s[:, phases[0][0]], s[:, 21] - s[:, 20]
    say(f"[{tag} stamps] per block {tot.mean():.0f} cycles (min {tot.min():.0f}, max "
        f"{tot.max():.0f}), {ns.mean():.0f} ns -> {np.mean(tot / ns):.3f} GHz")
    for a, b, name in phases:
        d = s[:, b] - s[:, a]
        say(f"[{tag} stamps] {name:52s} {d.mean():8.0f} cycles (max {d.max():8.0f}) "
            f"{d.mean() / tot.mean():.3f}")


def ctypes_call(fn, argtypes, args, stream):
    """fn(*args, stream) through ctypes: tensors as their pointers, ints as
    ints; raises on a non-zero cudaError."""
    fn.argtypes = argtypes
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a) for a in args]

    def go():
        status = fn(*vals, stream)
        if status != 0:
            raise RuntimeError(f"cudaError {status}")
    return go


def sass_counts(so, tag):
    """Instructions of each kernel in `so` by kind (cuobjdump -sass)."""
    dump = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", so], capture_output=True,
                          text=True).stdout
    for f in re.split(r"\n\s*Function : ", dump)[1:]:
        tag_f = f"{tag} {f.split(chr(10), 1)[0].strip()[:48]}"
        ops = [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0]
               for i in re.findall(r"/\*[0-9a-f]{4,6}\*/\s+([^;]*);", f) if i.strip()]
        cnt = {}
        for o in ops:
            cnt[o.split(".")[0]] = cnt.get(o.split(".")[0], 0) + 1
        keys = ("LDL", "STL", "MUFU", "CALL", "FCHK", "BAR", "SHFL", "LDS", "LDGSTS", "FFMA", "BRA")
        say(f"[sass] {tag_f}: {len(ops)} instructions; " + ", ".join(f"{k} {cnt.get(k, 0)}" for k in keys))


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
    blocked = "warp_solve_blocked" in src
    sources = {"k4_stamped": csrc_text(tree, "ipm_iter.cu",
                                       BLOCKED_PATCHES if blocked else ONE_WARP_PATCHES)}
    src = csrc_text(tree, "ipm_iter.cu")
    if blocked:
        call = "      warp_solve_blocked(sL, ld, npad, sdt, sinv, sx, lane);\n"
        if "v[j] = div_rn(v[j], c[j], iv[j]);" in src:   # the substitution in ipm_iter.cu
            mul = src.replace("v[j] = div_rn(v[j], c[j], iv[j]);", "v[j] = v[j] * iv[j];").replace(
                "v[j] = div_rn(v[j], r[j], iv[j]);", "v[j] = v[j] * iv[j];")
        else:                                              # trisolve.cuh's, with RECIP
            mul = patched(src, [(call, call.replace("warp_solve_blocked(",
                                                    "warp_solve_blocked<true>("))])
        sources["k4_recip_chain"] = mul
        sources["k4_no_substitution"] = patched(src, [(call, "")])
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
    say_phases("K4", read_stamps(libs["k4_stamped"])[:B],
               BLOCKED_PHASES if blocked else ONE_WARP_PHASES)


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


def condense_section(tree, dev, device_ms):
    """K2 and K6: device time, a stamped copy's phases, each against its
    plain version."""
    from chip_smoke import B, COL0, N, N2, NU, NX, NZ
    from tum_control_tpu_torch.ops.kernels import build as kb
    from tum_control_tpu_torch.ops.kernels import condense as cmod
    src = open(os.path.join(tree, "tum_control_tpu_torch", "csrc", "condense.cu")).read()
    barrier = "idx / nz" in src
    patches, phases, who = ((K2_BARRIER_PATCHES, K2_BARRIER_PHASES, K2_BARRIER_THREADS) if barrier
                            else (K2_COLUMN_PATCHES, K2_COLUMN_PHASES, K2_COLUMN_THREADS))
    sources = {"condense_stamped": csrc_text(tree, "condense.cu", patches)}
    if not barrier:
        sources.update({tag: csrc_text(tree, "condense.cu", vp)
                        for tag, vp in K2_COLUMN_VARIANTS.items()})
    libs = build(sources)
    lib = libs["condense_stamped"]
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    stable = lambda n: t(0.97 * np.eye(NX) + rng.normal(0, 0.05, (B, n, NX, NX)))
    k2 = (stable(N), t(rng.normal(0, 1, (B, N, NX, NU))), t(rng.normal(0, 0.01, (B, N, NX))),
          t(rng.normal(0, 0.1, (B, NX))))
    # K6 from a carry that is dense in every column
    k6 = (stable(N2), t(rng.normal(0, 1, (B, N2, NX, NU))), t(rng.normal(0, 0.01, (B, N2, NX))),
          t(rng.normal(0, 0.1, (B, NX))), t(rng.normal(0, 0.1, (B, NX, NZ))), COL0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    sig = kb.SIGNATURES["condense"]
    cases = (("K2", cmod.condense_cuda, cmod.condense_ref, k2, "condense_f32", N, (N, NX, NU)),
             ("K6", cmod.condense_from_cuda, cmod.condense_from_ref, k6, "condense_from_f32", N2,
              (N2, NX, NU, NZ, COL0)))
    for tag, kern, ref, args, sym, stages, ints in cases:
        say(f"[{tag}] {'barrier' if barrier else 'column'} design: kernel "
            f"{device_ms(lambda: kern(*args)):.5f} ms device ({stages} stages)")
        e, G = kern(*args)
        say(f"[{tag}] a fill of its Gamma ({G.numel() * 4 / 1e6:.1f} MB, Tensor.zero_): "
            f"{device_ms(G.zero_):.5f} ms device")
        ep, Gp = ref(*args)
        e.zero_(), G.zero_()
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        for vtag, vlib in libs.items():
            go = ctypes_call(getattr(vlib, sym), sig[sym], tensors + [e, G, B, *ints], stream)
            go()
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max() / r.abs().max()) for g, r in ((e, ep), (G, Gp)))
            say(f"[{tag}] {vtag}: {device_ms(go):.5f} ms device; worst output {err:.2e} of max "
                "|plain| from the plain version")
        go = ctypes_call(getattr(lib, sym), sig[sym], tensors + [e, G, B, *ints], stream)
        go()
        torch.cuda.synchronize()
        nblocks = B if barrier else cmod.condense_plan(stages, NX, NU, G.shape[-1]).blocks * B
        st, acc = read_stamps(lib)[:nblocks], read_acc(lib)[:nblocks]
        for w, name in enumerate(who):
            a = acc[:, w, :len(phases)]
            tot = a.sum(axis=1)
            ns = st[:, 21] - st[:, 20]
            say(f"[{tag} stamps] {name}: per block {tot.mean():.0f} cycles, {ns.mean():.0f} ns of "
                f"the block -> {np.mean(tot / ns):.3f} GHz")
            for q, ph in enumerate(phases):
                say(f"[{tag} stamps]   {ph:56s} {a[:, q].mean():8.0f} cycles (max "
                    f"{a[:, q].max():8.0f}) {a[:, q].mean() / tot.mean():.3f}")


def solve_section(tree, dev, device_ms):
    """K5 and the K7 solve: device time; K5's phases in a stamped copy."""
    from chip_smoke import B, NZ
    from tum_control_tpu_torch.ops.kernels import build as kb
    from tum_control_tpu_torch.ops.kernels import chol as cmod
    src = open(os.path.join(tree, "tum_control_tpu_torch", "csrc", "chol.cu")).read()
    one_warp = "warp_chol_solve" in src
    patches, headers, phases = ((K5_ONE_WARP_PATCHES, K5_ONE_WARP_HEADERS, K5_ONE_WARP_PHASES)
                                if one_warp else
                                (K5_BLOCKED_PATCHES, K5_BLOCKED_HEADERS, K5_BLOCKED_PHASES))
    lib = build({"chol_stamped": csrc_text(tree, "chol.cu", patches, headers)})["chol_stamped"]
    rng = np.random.default_rng(1)
    A = rng.standard_normal((B, NZ, NZ + 4))
    H = A @ A.transpose(0, 2, 1) / NZ + 0.5 * np.eye(NZ)
    L = torch.tensor(np.linalg.cholesky(H), dtype=torch.float32, device=dev)
    b = torch.tensor(rng.standard_normal((B, NZ)), dtype=torch.float32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    sig = kb.SIGNATURES["chol"]
    for tag, kern, ref, sym in (("K5", cmod.chol_solve_cuda, cmod.chol_solve_ref, "chol_solve_f32"),
                                ("K7 solve", cmod.chol_solve_unblocked_cuda,
                                 cmod.chol_solve_unblocked_ref, "chol_solve_unblocked_f32")):
        say(f"[{tag}] {'one-warp' if one_warp else 'blocked'} design: kernel "
            f"{device_ms(lambda: kern(L, b)):.5f} ms device (n = {NZ})")
        x = torch.empty_like(b)
        go = ctypes_call(getattr(lib, sym), sig[sym], [L, b, x, B, NZ], stream)
        go()
        torch.cuda.synchronize()
        xp = ref(L, b)
        say(f"[{tag}] stamped copy: {device_ms(go):.5f} ms device; x {float((x - xp).abs().max() / xp.abs().max()):.2e}"
            " of max |plain| from the plain version")
        go()
        torch.cuda.synchronize()
        say_phases(tag, read_stamps(lib)[:B], phases)


def library_sass(names):
    """SASS counts of the tree's own kernel libraries (built if needed)."""
    from tum_control_tpu_torch.ops.kernels import build as kb
    kb.build_all()
    for name in names:
        sass_counts(kb._lib_path(name), f"lib{name}")


SECTIONS = {"condense": condense_section, "solve": solve_section, "k4": k4, "k1": k1}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=REPO, help="checkout whose kernels to take apart")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help=f"comma-separated, of {','.join(SECTIONS)}")
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sections = opts.sections.split(",")
    if not set(sections) <= set(SECTIONS):
        ap.error(f"unknown section in {opts.sections}")
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
    library_sass({"condense": ["condense"], "solve": ["chol"], "k4": ["ipm_iter"],
                  "k1": ["linearize"]}[s][0] for s in sections)
    for s in sections:
        SECTIONS[s](tree, dev, device_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
