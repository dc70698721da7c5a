"""Times variants of the multi-row decode kernels (K4 and K5 above 32 rows a
kv-head), and of K5q (the int8 pool's decode attention), on one NVIDIA GPU.

    python3 chip_decode_variants.py [name,name,...]

Each variant is this checkout's ``neuronx_distributed_tpu_torch`` copied
into ``build/variants/<name>`` (git-ignored) with source substitutions in
``csrc/flash_decode.cu``, built there and run in a process of its own, in
the order given (default: every variant, the first again at the end, to
show the spread). Variants that keep the kernel's function are checked by
``chip_smoke.check_decode_rows`` (the limits, bitwise reproducibility, K5 =
K4 gathered) and timed by it; those named ``*_t`` change the arithmetic to
show what a part of it costs and are timed only, on the same inputs. Each
prints one JSON line: per R (64, 1024, 2048 rows a kv-head at phase 5c's
geometry), K4's and K5's time as CUDA-graph replays, and the registers
``ptxas`` gave the multi-row kernels. Variants named ``k5q*`` change K5q
instead: checked by ``chip_smoke.check_k5q`` (its limits, K5q = K4 on the
dequantized view bit for bit, three graph replays) and timed by it at
K4's geometry and the paged serving geometry, beside K5 on the bf16 pool
in the same process; their line gives K5q's registers and blocks an SM.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

WGS = "constexpr int RWGS = 3;"
STAGES = "constexpr int RSTAGES = 2;"
K5Q_BODY = "  decode_range<RMAX, QPagedCols>(p, dsm, blockIdx.y, blockIdx.x, blockIdx.z);"
K5Q_LAUNCH = "  kernel_of<RMAX>(kind)<<<dim3(p.Hkv, p.B, p.n_splits), NTHREADS, smem, stream>>>(p);"
# persistent: as many blocks as the card holds, each walking the (range, slot, kv-head) items
# below the live bound, range-major, at a stride of the grid
K5Q_RESIDENT = [
    (K5Q_BODY, """  const int per = p.B * p.Hkv, items = max((live_bound(p) + SPLIT - 1) / SPLIT, 1) * per;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    decode_range<RMAX, QPagedCols>(p, dsm, item / p.Hkv % p.B, item % p.Hkv, item / per);
    __syncthreads();  // the next item reuses the shared memory
  }"""),
    (K5Q_LAUNCH, """  if (kind == QPAGED) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of<RMAX>(kind), NTHREADS, smem);
    const int items = p.n_splits * p.B * p.Hkv;
    kernel_of<RMAX>(kind)<<<items < sms * per_sm ? items : sms * per_sm, NTHREADS, smem, stream>>>(p);
  } else {
""" + K5Q_LAUNCH + "\n  }"),
]
# a TMA box a page (page_size rows x 128 B of one kv-head, through a 4-D map of the pool,
# 128-byte swizzle) into 1024-byte stages, completing on the stage's mbarrier, in place of
# 16-byte cp.async copies of each column; a box without a live column is not loaded (its
# stale rows meet p = 0); the scale words stay cp.async copies
K5Q_TMA_LOAD = """// (TMA) a tile's int8 K and V, one box a page of its columns (`rows`
// columns; a box with no live column is not loaded) through the stage's
// mbarrier; the scale words as before, by warps 1 and up
__device__ __forceinline__ void load_tile(unsigned char* stage, const QPagedCols& cols,
                                          const uint8_t* live_s, int c_begin, int tile, int tid) {
  const Params& p = cols.p;
  uint32_t* kw = reinterpret_cast<uint32_t*>(stage + 2 * TL * D);
  uint32_t* vw = kw + TL;
  uint8_t* half = reinterpret_cast<uint8_t*>(vw + TL);
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + QBAR);
  const int ps = 1 << p.ps_shift, rows = ps < TL ? ps : TL, nbox = TL / rows;
  const int sshift = cols.sshift(), c0 = tile * TL;
  if (tid < 32) {
    const unsigned lo = __ballot_sync(0xffffffffu, live_s[c0 + tid] != 0);
    const unsigned hi = __ballot_sync(0xffffffffu, live_s[c0 + 32 + tid] != 0);
    const unsigned long long m = (unsigned long long)hi << 32 | lo;
    const unsigned long long bits = rows == 64 ? ~0ull : (1ull << rows) - 1;
    const bool mine = tid < nbox && ((m >> (tid * rows)) & bits) != 0;
    const unsigned issue = __ballot_sync(0xffffffffu, mine);
    if (tid == 0) mbar_arrive_expect_tx(bar, (uint32_t)(__popc(issue) * 2 * rows * D));
    __syncwarp();
    if (mine) {
      const int cs = c0 + tid * rows;
      const int page = cols.pg[cs >> p.ps_shift];
      const int row = (c_begin + cs) & (ps - 1);
      tma_load_4d(stage + tid * rows * D, &p.tmk, bar, 0, cols.hk, row, page);
      tma_load_4d(stage + TL * D + tid * rows * D, &p.tmv, bar, 0, cols.hk, row, page);
    }
  } else if (tid - 32 < (TL >> sshift)) {  // the pages' scale words, and the halves
    const int slot = tid - 32;
    const long long pid = cols.pg[(c0 + (slot << sshift)) >> p.ps_shift];
    const uintptr_t ka = reinterpret_cast<uintptr_t>(p.ks + pid * p.sksp + cols.hk * p.sksh);
    const uintptr_t va = reinterpret_cast<uintptr_t>(p.vs + pid * p.svsp + cols.hk * p.svsh);
    cp_async4_zfill(kw + slot, reinterpret_cast<const void*>(ka & ~uintptr_t(3)), pid ? 4 : 0);
    cp_async4_zfill(vw + slot, reinterpret_cast<const void*>(va & ~uintptr_t(3)), pid ? 4 : 0);
    half[slot] = (uint8_t)((ka >> 1) & 1);
    half[TL + slot] = (uint8_t)((va >> 1) & 1);
  }
}

"""
K5Q_TMA_ENCODE = """// (TMA) the map of an int8 pool (P, ps, H, 128) with byte strides (sp, sr,
// sh): dims innermost first (128, H, ps, P), a box of 128 B x 1 head x
// `rows` rows, 128-byte swizzle
static int encode_pool(CUtensorMap* map, const void* base, int P, int ps, int H, long long sp,
                       long long sr, long long sh, int rows) {
  const nxd_hopper::TensorMapEncodeTiled enc = nxd_hopper::tensor_map_encoder();
  if (enc == nullptr) return nxd_hopper::ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {128, (cuuint64_t)H, (cuuint64_t)ps, (cuuint64_t)P};
  const cuuint64_t strides[3] = {(cuuint64_t)sh, (cuuint64_t)sr, (cuuint64_t)sp};
  const cuuint32_t box[4] = {128, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : nxd_hopper::ERR_ENCODE + (int)r;
}

"""
K5Q_TMA = [
    ("  float scale;\n};", "  float scale;\n  CUtensorMap tmk, tmv;  // K5q's pools (TMA)\n};"),
    ("constexpr int QSTAGE_BYTES = TL * QKP + TL * D + 2 * TL * 4 + 2 * TL;",
     "constexpr int QBAR = 2 * TL * D + 2 * TL * 4 + 2 * TL;  // the stage's mbarrier\n"
     "constexpr int QSTAGE_BYTES = 17 * 1024;  // 1024-byte stages: the swizzle's period"),
    ("    stages = dsm;\n    q = reinterpret_cast<bf16*>(dsm + STAGES * sb);",
     "    stages = sb == QSTAGE_BYTES ? align1024(dsm) : dsm;\n"
     "    q = reinterpret_cast<bf16*>(stages + STAGES * sb);"),
    ("(quant ? SPLIT * sizeof(int) : 0);", "(quant ? SPLIT * sizeof(int) + 1024 : 0);"),
    ("__device__ __forceinline__ void load_tile(unsigned char* stage, const QPagedCols& cols,",
     K5Q_TMA_LOAD + "__device__ __forceinline__ void load_tile_cp(unsigned char* stage, "
     "const QPagedCols& cols,"),
    ("st + TL * QKP + TL * D", "st + 2 * TL * D"),
    ("    const unsigned char* kq = st + col * QKP + k;",
     "    const unsigned char* kq = st + col * D + ((((k >> 4) ^ (col & 7)) << 4) | (k & 15));"),
    ("st + TL * QKP + c * D + d0)", "st + TL * D + c * D + ((((d0 >> 4) ^ (c & 7)) << 4) | (d0 & 15)))"),
    ("""  constexpr int SB = stage_bytes<Cols>();
#pragma unroll""", """  constexpr int SB = stage_bytes<Cols>();
  if constexpr (Cols::QUANT) {  // a stage's mbarrier: its tile's boxes
    if (tid == 0) {
      for (int x = 0; x < STAGES; ++x)
        mbar_init(reinterpret_cast<uint64_t*>(sm.stages + x * SB + QBAR), 1);
      mbar_init_fence();
    }
    __syncthreads();
  }
#pragma unroll"""),
    ("    cp_async_wait<STAGES - 2>();  // tile i (and q) landed\n",
     "    cp_async_wait<STAGES - 2>();  // tile i (and q) landed\n"
     "    if constexpr (Cols::QUANT)\n"
     "      mbar_wait(reinterpret_cast<uint64_t*>(sm.stages + (i % STAGES) * SB + QBAR), (i / STAGES) & 1);\n"),
    ("""        for (int e = 0; e < 8; ++e) st.acc[k][e] += pk[k] * vf[e];
    }
  }
}""", """        for (int e = 0; e < 8; ++e) st.acc[k][e] += pk[k] * vf[e];
    }
  }
  if constexpr (Cols::QUANT) {  // every wait is past: the stages become reduce_rows' sums
    if (tid == 0)
      for (int x = 0; x < STAGES; ++x)
        asm volatile("mbarrier.inval.shared::cta.b64 [%0];\\n" ::"r"(smem_u32(sm.stages + x * SB + QBAR))
                     : "memory");
  }
}"""),
    ("qpaged_flash_decode_kernel(Params p) {", "qpaged_flash_decode_kernel(const __grid_constant__ Params p) {"),
    ('extern "C" int nxd_qpaged_flash_decode_fwd(', K5Q_TMA_ENCODE + 'extern "C" int nxd_qpaged_flash_decode_fwd('),
    ("  return dispatch(p, QPAGED, stream);", """  const int rows = (1 << ps_shift) < TL ? 1 << ps_shift : TL;
  int err;
  if ((err = encode_pool(&p.tmk, k, n_pages, 1 << ps_shift, Hkv, skp, skr, skh, rows))) return err;
  if ((err = encode_pool(&p.tmv, v, n_pages, 1 << ps_shift, Hkv, svp, svr, svh, rows))) return err;
  return dispatch(p, QPAGED, stream);"""),
]
# the range's table entries read by every block before the bound check in place of by a
# range with a live tile, after its vote
K5Q_PG_LATE = """  if constexpr (Cols::QUANT) {
    // K5q: the range's pages, each read once (0 past the table), by a
    // range with a live tile only: a dead block returns without a read
    if ((tid & ((1 << p.ps_shift) - 1)) == 0)
      sm.pg[tid >> p.ps_shift] = col < p.L ? __ldg(p.bt + b * p.sbt + (col >> p.ps_shift)) : 0;
    __syncthreads();
    range_tiles<RMAX>(p, sm, Cols(p, hk, sm.pg), tiles, c_begin, R, part);
  } else {"""
K5Q_PGEARLY = [
    ("  const int bound = live_bound(p);\n  if (c_begin >= bound) return;",
     """  if constexpr (Cols::QUANT) {
    if ((tid & ((1 << p.ps_shift) - 1)) == 0)
      sm.pg[tid >> p.ps_shift] = col < p.L ? __ldg(p.bt + b * p.sbt + (col >> p.ps_shift)) : 0;
  }
  const int bound = live_bound(p);
  if (c_begin >= bound) return;"""),
    (K5Q_PG_LATE, """  if constexpr (Cols::QUANT) {
    range_tiles<RMAX>(p, sm, Cols(p, hk, sm.pg), tiles, c_begin, R, part);
  } else {"""),
]
VARIANTS = {  # name: (old, new) substitutions in csrc/flash_decode.cu
    "wg3": [],                                   # as built: three warpgroups a block
    "wg2": [(WGS, WGS.replace("3", "2"))],
    "wg1": [(WGS, WGS.replace("3", "1"))],       # one warpgroup, two blocks an SM
    "wg1_stages4": [(WGS, WGS.replace("3", "1")), (STAGES, STAGES.replace("2", "4"))],
    "wg3_no_lo_t": [("    rs_product(o, pl, v_desc, 1);\n", "")],  # P V with P_hi only
    "wg3_no_exp_t": [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = x;")],
    "k5q": [],                                   # as built: K5's plan and merge kernel
    "k5q_resident": K5Q_RESIDENT,
    "k5q_tma": K5Q_TMA,
    "k5q_pgearly": K5Q_PGEARLY,
}

K5Q_CHILD = r"""
import ctypes, json, sys
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[3])
import torch
import chip_smoke as cs
from neuronx_distributed_tpu_torch.kernels import _build
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd

lib = _build.load("flash_decode")
vals = (ctypes.c_int * 4)()
_build.check(lib.nxd_flash_decode_resources(2, 4, vals), "flash_decode")
gen = torch.Generator(device="cuda").manual_seed(12)
out = dict(variant=sys.argv[2], regs=vals[1], local=vals[2], blocks_per_sm=vals[3])
for shapes in ("k4", "serving"):
    q, kp, vp, bt, pos, valid = cs.k5_inputs(gen, shapes)
    out[f"k5_{shapes}_ms"] = cs.graph_ms(lambda: tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos,
                                                                            valid, 16), 20)
    del q, kp, vp, bt, pos, valid
    if sys.argv[2].endswith("_t"):  # not the kernel's function: timed only
        q, kp, vp, bt, pos, valid = cs.k5_inputs(gen, shapes)
        (kq, ks), (vq, vs) = tfd.quantize_page_block(kp), tfd.quantize_page_block(vp)
        out[f"k5q_{shapes}_ms"] = cs.graph_ms(lambda: tfd.paged_flash_decode_fwd(
            q, kq, vq, bt, pos, valid, 16, ks, vs), 20)
        out[f"k5q_{shapes}_cold_ms"] = cs.k5q_cold_ms(q, kq, vq, ks, vs, bt, pos, valid, 16)
    else:
        r = cs.check_k5q(gen, shapes)
        out[f"k5q_{shapes}_ms"], out[f"k5q_{shapes}_ratio"] = r["ms"], r["ratio"]
        out[f"k5q_{shapes}_cold_ms"] = r["cold_ms"]
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[3])
import torch
import chip_smoke as cs
from neuronx_distributed_tpu_torch.kernels import _build
from neuronx_distributed_tpu_torch.kernels import flash_decode as tfd

_build.build(["flash_decode"])
report = _build.resource_report("flash_decode").splitlines()
regs = [next(x for x in report[i:] if "Used" in x).split("Used")[1].split(",")[0].strip()
        for i, line in enumerate(report) if "entry function" in line and "_rows" in line]
gen = torch.Generator(device="cuda").manual_seed(0)
rows = {}
for chunk in (16, 256, 512):
    if sys.argv[2].endswith("_t"):  # not the kernel's function: timed only
        q, kc, vc, pos, valid = cs.rows_inputs(gen, chunk)
        kp, vp, bt = cs.scrambled_pages(kc, vc, valid)
        rows[4 * chunk] = dict(
            ms=cs.graph_ms(lambda: tfd.flash_decode_fwd(q, kc, vc, pos, valid), 5),
            paged_ms=cs.graph_ms(lambda: tfd.paged_flash_decode_fwd(q, kp, vp, bt, pos, valid, 16), 5))
    else:
        r = cs.check_decode_rows(gen, chunk)
        rows[4 * chunk] = dict(ms=r["ms"], paged_ms=r["paged_ms"], ratio=r["ratio"])
print("RESULT " + json.dumps(dict(variant=sys.argv[2], rows=rows, regs=regs)), flush=True)
"""


def make(name: str) -> str:
    """The variant's copy of the package; returns the directory to import from."""
    dst = os.path.join(ROOT, "build", "variants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "neuronx_distributed_tpu_torch"),
                    os.path.join(dst, "neuronx_distributed_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(dst, "neuronx_distributed_tpu_torch", "csrc", "flash_decode.cu")
    with open(src) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    return dst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_decode_variants: no CUDA device is available", file=sys.stderr)
        return 1
    order = sys.argv[1].split(",") if len(sys.argv) > 1 else [*VARIANTS, next(iter(VARIANTS))]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(dict(card=card)), flush=True)
    trees = {name: make(name) for name in dict.fromkeys(order)}
    failed = 0
    for name in order:
        child = K5Q_CHILD if name.startswith("k5q") else CHILD
        r = subprocess.run([sys.executable, "-c", child, trees[name], name, ROOT],
                           capture_output=True, text=True)
        line = next((x for x in r.stdout.splitlines() if x.startswith("RESULT ")), None)
        if line is None:
            failed += 1
            print(f"variant {name} failed (rc {r.returncode}):\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}",
                  flush=True)
        else:
            print(line[len("RESULT "):], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
