"""Scratch copies of the package with one lever of the v7, v8 (B4 too), v9
or A-Trous design undone, for ablations on a GPU (times only; no copy is a
configuration of the package).

No JAX counterpart.  ``python3 -m realtimeraytracer_torch.ablate <dir>
[name ...]`` writes ``<dir>/<name>/realtimeraytracer_torch`` (and a link to
the repository's assets) for each named variant, or for all of them; then
``PYTHONPATH=<dir>/<name> python3 realtimeraytracer_torch/kernel_ab.py
kernels <name> --no-foliage`` times it beside the unchanged tree.  Each
variant replaces exact stretches of a kernel source and fails if one of
them is gone:

- v8_bitonic_l2: the L2 keys sorted by the bitonic network (28 barriers)
  instead of by rank;
- v8_sync_staging: blocks and blk pages copied by plain 16-byte loads and
  stores instead of cp.async;
- v8_all_rays: every lane counted live in the culls' compaction (the culls
  test retired and empty rays too, and a tile with no live ray still culls);
  B4's culls too;
- b4_sync_staging: B4 waits for every copy group, the prefetched next
  block's and page's included, before each cull and visit (no copy
  overlaps a test);
- b4_branch_quotient: B4's sample test branches around its division where
  |s1| <= EPS, as single v8's visit does, instead of dividing in every lane;
- b4_five_ctas: B4 asks for 4 KB more shared memory, so five CTAs fit an
  SM at S = 3 instead of six;
- b4_test_twice: B4 runs each visit's transposed test twice (the same
  results: the difference in time is the test's share);
- b4_no_skip: B4 waits for and tests a block that no sample's slab test
  passes (a visit over no active ray);
- b4_per_ray_visit: B4's visit tests one ray a thread, each walking the
  staged block's 128 triangles while a sample is to do (the design before
  the transposed visit), behind the same culls, staging and skip;
- sync_staging: v7's blocks and v9's composites copied by plain loads
  instead of cp.async (tile_trace.cuh, which both include);
- v7_prologue_only, v9_prologue_only: the kernel runs its cull and sort
  and no visit;
- nv1, nv2: one or two triangles per step of v7's and v9's test loops
  instead of four (tile_trace.cuh);
- atrous_unstaged: the A-Trous pair reads every tap and centre from global
  memory (the same loop and reuse; no shared staging);
- atrous_py2: two output rows a thread instead of four (fewer registers,
  more CTAs an SM, less reuse of each staged tap);
- vjp_two_ctas, vjp_four_ctas: B5b with geometry gradients capped for two
  or four resident CTAs an SM instead of three (88 registers; 64, which
  spill);
- vjp_colour_three_ctas: B5b without them capped for three instead of four;
- vjp_forward_weights: B5b evaluates each tap's weights exactly as the
  forward does (four clamped expf of unfused squared distances), so they
  round as the W and outputs it reads;
- vjp_four_exps: B5b evaluates the forward's four clamped weights a tap
  (four expf) instead of one exp of the summed exponents per image;
- vjp_column_residues: B5b stages one column residue class at every step
  (36 strided columns) instead of a contiguous segment up to step 8.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent

# name -> (source, [(stretch, replacement), ...])
VARIANTS = {
    "v8_bitonic_l2": ("trace_v8.cu", [(
        """  in[lane] = own;
  __syncthreads();
  keys[rank_of(in, SUP, own)] = own;
  __syncthreads();""",
        """  keys[lane] = own;
  __syncthreads();
  bitonic_sort(keys, SUP);""")]),
    "v8_sync_staging": ("trace_v8.cu", [(
        """  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s), "l"(src) : "memory");""",
        """  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);""")]),
    "v8_all_rays": ("trace_v8.cu", [(
        """  const unsigned m = __ballot_sync(FULL, live);""",
        """  live = true;
  const unsigned m = __ballot_sync(FULL, live);""")]),
    "b4_sync_staging": ("trace_v8.cu", [(
        """    if (pre) cp_async_wait<1>(); else cp_async_wait<0>();
    const int live2 = compact_live(L, tmin <= lim);""",
        """    cp_async_wait<0>();
    const int live2 = compact_live(L, tmin <= lim);"""), (
        """      visit_multi<S, COUNT>(coefb[cbuf], bpre, page, b,""",
        """      cp_async_wait<0>();
      visit_multi<S, COUNT>(coefb[cbuf], false, page, b,""")]),
    "b4_branch_quotient": ("trace_v8.cu", [(
        """        const float q = (-s0) / s1;       // every lane: a branch around it costs more
        const float t = den_ok ? q : BIG;""",
        """        const float t = den_ok ? (-s0) / s1 : BIG;""")]),
    "b4_five_ctas": ("trace_v8.cu", [(
        """  const size_t smem = s_count * sizeof(Samples<1>) + (size_t)cap1 * sizeof(int);""",
        """  const size_t smem = s_count * sizeof(Samples<1>) + (size_t)cap1 * sizeof(int) + 4096;""")]),
    "b4_test_twice": ("trace_v8.cu", [(
        """  test_block<S, COUNT>(coef, T, P, L, V);
  __syncthreads();                          // the warps' votes""",
        """  test_block<S, COUNT>(coef, T, P, L, V);
  test_block<S, COUNT>(coef, T, P, L, V);
  __syncthreads();                          // the warps' votes""")]),
    "b4_no_skip": ("trace_v8.cu", [(
        """  if (active == 0) return;                  // no sample needs the block
""", "")]),
    "b4_per_ray_visit": ("trace_v8.cu", [(
        """  test_block<S, COUNT>(coef, T, P, L, V);
  __syncthreads();                          // the warps' votes
  if (todo) retire<S, COUNT>(V, slot, todo, P, occ, lim, tests, fams);""",
        """  const float* cf = coef;
  for (int j = 0; j < TILE && todo; ++j) {
    const float s0 = ((o[0] * cf[j] + o[1] * cf[TILE + j]) + o[2] * cf[2 * TILE + j]) +
                     cf[3 * TILE + j];
    const float ou = ((o[0] * cf[4 * TILE + j] + o[1] * cf[5 * TILE + j]) +
                      o[2] * cf[6 * TILE + j]) + cf[7 * TILE + j];
    const float ov = ((o[0] * cf[8 * TILE + j] + o[1] * cf[9 * TILE + j]) +
                      o[2] * cf[10 * TILE + j]) + cf[11 * TILE + j];
    if (COUNT) ++fams;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (!((todo >> s) & 1u)) continue;
      if (COUNT) ++tests;
      const float4 dt = P.dt[s][lane];
      const float s1 = (dt.x * cf[j] + dt.y * cf[TILE + j]) + dt.z * cf[2 * TILE + j];
      const float du = (dt.x * cf[4 * TILE + j] + dt.y * cf[5 * TILE + j]) + dt.z * cf[6 * TILE + j];
      const float dv = (dt.x * cf[8 * TILE + j] + dt.y * cf[9 * TILE + j]) + dt.z * cf[10 * TILE + j];
      const bool den_ok = fabsf(s1) > EPS;
      const float t = den_ok ? (-s0) / s1 : BIG;
      const float u = ou + t * du;
      const float v = ov + t * dv;
      if (den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin && t <= dt.w) {
        todo &= ~(1u << s);
        occ |= 1u << s;
      }
    }
  }
  lim = live_limit<S>(P, lane, occ);""")]),
    "sync_staging": ("tile_trace.cuh", [(
        """  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(s), "l"(src),
               "r"(fill ? 16 : 0) : "memory");""",
        """  *reinterpret_cast<float4*>(dst) = fill ? *reinterpret_cast<const float4*>(src)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);""")]),
    "v7_prologue_only": ("trace_v7.cu", [("  if (n > 0) stage(0);", "  n = 0;")]),
    "v9_prologue_only": ("trace_v9.cu", [("  if (nmax > 0) stage(0);", "  nmax = 0;")]),
    "nv1": ("tile_trace.cuh", [("constexpr int NV = 4;", "constexpr int NV = 1;")]),
    "nv2": ("tile_trace.cuh", [("constexpr int NV = 4;", "constexpr int NV = 2;")]),
    "atrous_unstaged": ("atrous_pair.cu", [
        ("    const int n = schunks[jj][k];", "    const int n = 0;"),
        ("""    const int f = jj * geo.row_floats + (pix_ok[p] ? sbase[jj][seg] + 3 * x : 0);
    load3(sp + f, cs[p]);
    load3(up + f, cu[p]);
    load3(np + f, cn[p]);
    load3(pp + f, cp[p]);""",
         """    const size_t f = pix_ok[p] ? ((size_t)(y_first + (jj - 2) * step) * w + x) * 3 : 0;
    load3(s_in + f, cs[p]);
    load3(u_in + f, cu[p]);
    load3(nrm + f, cn[p]);
    load3(pos + f, cp[p]);"""),
        ("""      const int f = sbase[jj][geo.nseg == 1 ? 0 : kx] + 3 * xx;
      float qs[3], qu[3], qn[3], qp[3];
      load3(srow + f, qs);
      load3(srow + plane_floats + f, qu);
      load3(srow + 2 * plane_floats + f, qn);
      load3(srow + 3 * plane_floats + f, qp);""",
         """      const size_t f = ((size_t)yy * w + xx) * 3;
      float qs[3], qu[3], qn[3], qp[3];
      load3(s_in + f, qs);
      load3(u_in + f, qu);
      load3(nrm + f, qn);
      load3(pos + f, qp);""")]),
    "atrous_py2": ("atrous_pair.cu", [
        ("constexpr int PY = 4;             // output rows per thread",
         "constexpr int PY = 2;             // output rows per thread")]),
    "vjp_two_ctas": ("atrous_pair_vjp.cu", [
        ("constexpr int MIN_BLOCKS_GEOM = 3;", "constexpr int MIN_BLOCKS_GEOM = 2;")]),
    "vjp_four_ctas": ("atrous_pair_vjp.cu", [
        ("constexpr int MIN_BLOCKS_GEOM = 3;", "constexpr int MIN_BLOCKS_GEOM = 4;")]),
    "vjp_colour_three_ctas": ("atrous_pair_vjp.cu", [
        ("constexpr int MIN_BLOCKS_COLOUR = 4;", "constexpr int MIN_BLOCKS_COLOUR = 3;")]),
    "vjp_forward_weights": ("atrous_pair_vjp.cu", [(
        """struct Consts {
  float neg_inv_c, neg_inv_np, neg_inv_p;   // the exponents' factors""",
        """struct Consts {
  float inv_step2, inv_c, inv_n, inv_p;""",
    ), (
        """  const Consts k{-inv_c, -(inv_step2 * inv_n), -inv_p,""",
        """  const Consts k{inv_step2, inv_c, inv_n, inv_p,""",
    ), (
        """      const float t = fmaf(dot3(dp, dp), k.neg_inv_p, dot3(dn, dn) * k.neg_inv_np);
      const float kern = KERNEL5[ky * 5 + kx];
      const float a_s = kern * expf(fmaf(dot3(dcs, dcs), k.neg_inv_c, t));
      const float a_u = kern * expf(fmaf(dot3(dcu, dcu), k.neg_inv_c, t));""",
        """      const auto sq = [](float3 d) { return (d.x * d.x + d.y * d.y) + d.z * d.z; };
      const float w_n = fminf(expf(-(sq(dn) * k.inv_step2) * k.inv_n), 1.0f);
      const float w_p = fminf(expf(-sq(dp) * k.inv_p), 1.0f);
      const float wnp = (w_n * w_p) * KERNEL5[ky * 5 + kx];
      const float a_s = fminf(expf(-sq(dcs) * k.inv_c), 1.0f) * wnp;
      const float a_u = fminf(expf(-sq(dcu) * k.inv_c), 1.0f) * wnp;""")]),
    "vjp_four_exps": ("atrous_pair_vjp.cu", [(
        """      const float t = fmaf(dot3(dp, dp), k.neg_inv_p, dot3(dn, dn) * k.neg_inv_np);
      const float kern = KERNEL5[ky * 5 + kx];
      const float a_s = kern * expf(fmaf(dot3(dcs, dcs), k.neg_inv_c, t));
      const float a_u = kern * expf(fmaf(dot3(dcu, dcu), k.neg_inv_c, t));""",
        """      const float wnp = (fminf(expf(dot3(dn, dn) * k.neg_inv_np), 1.0f)
                         * fminf(expf(dot3(dp, dp) * k.neg_inv_p), 1.0f)) * KERNEL5[ky * 5 + kx];
      const float a_s = fminf(expf(dot3(dcs, dcs) * k.neg_inv_c), 1.0f) * wnp;
      const float a_u = fminf(expf(dot3(dcu, dcu) * k.neg_inv_c), 1.0f) * wnp;""")]),
    "vjp_column_residues": ("atrous_pair_vjp.cu", [
        ("constexpr int KMAX = 8;", "constexpr int KMAX = 0;")]),
}


def write_variant(out: Path, name: str) -> Path:
    """Writes <out>/<name>/realtimeraytracer_torch with variant `name`'s
    edit; returns <out>/<name> (the PYTHONPATH entry)."""
    source, edits = VARIANTS[name]
    root = out / name
    if root.exists():
        shutil.rmtree(root)
    dst = root / PKG.name
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "assets").symlink_to(PKG.parent / "assets")
    path = dst / "csrc" / source
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: a stretch it replaces in {source} is gone or ambiguous")
        text = text.replace(old, new)
    path.write_text(text)
    return root


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    out = Path(argv[0])
    for name in argv[1:] or VARIANTS:
        print(write_variant(out, name))


if __name__ == "__main__":
    main()
