"""Scratch copies of the package with one lever of the v8 / v9 design undone,
for ablations on a GPU (times only; no copy is a configuration of the
package).

No JAX counterpart.  ``python3 -m realtimeraytracer_torch.ablate <dir>
[name ...]`` writes ``<dir>/<name>/realtimeraytracer_torch`` (and a link to
the repository's assets) for each named variant, or for all of them; then
``PYTHONPATH=<dir>/<name> python3 realtimeraytracer_torch/kernel_ab.py
kernels <name> --no-foliage`` times it beside the unchanged tree.  Each
variant replaces one exact stretch of a kernel source and fails if that
stretch is gone:

- v8_bitonic_l2: the L2 keys sorted by the bitonic network (28 barriers)
  instead of by rank;
- v8_sync_staging: blocks and blk pages copied by plain 16-byte loads and
  stores instead of cp.async;
- v8_all_rays: every lane counted live in the culls' compaction (the culls
  test retired and empty rays too, and a tile with no live ray still culls);
- v9_sync_gather: v9's composites gathered by plain loads instead of
  cp.async;
- v9_prologue_only: v9 runs its cull and sort and no visit;
- v9_nv1, v9_nv2: one or two triangles per step of v9's test loop instead
  of four.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent

VARIANTS = {
    "v8_bitonic_l2": ("trace_v8.cu", (
        """    l2in[lane] = k2own;
    __syncthreads();
    l2keys[rank_of(l2in, SUP, k2own)] = k2own;
    __syncthreads();""",
        """    l2keys[lane] = k2own;
    __syncthreads();
    bitonic_sort(l2keys, SUP);""")),
    "v8_sync_staging": ("trace_v8.cu", (
        """  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s), "l"(src) : "memory");""",
        """  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);""")),
    "v8_all_rays": ("trace_v8.cu", (
        """  const unsigned m = __ballot_sync(FULL, live);""",
        """  live = true;
  const unsigned m = __ballot_sync(FULL, live);""")),
    "v9_sync_gather": ("trace_v9.cu", (
        """  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(s), "l"(src),
               "r"(fill ? 16 : 0) : "memory");""",
        """  *reinterpret_cast<float4*>(dst) = fill ? *reinterpret_cast<const float4*>(src)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);""")),
    "v9_prologue_only": ("trace_v9.cu", ("  if (nmax > 0) stage(0);", "  nmax = 0;")),
    "v9_nv1": ("trace_v9.cu", ("constexpr int NV = 4;", "constexpr int NV = 1;")),
    "v9_nv2": ("trace_v9.cu", ("constexpr int NV = 4;", "constexpr int NV = 2;")),
}


def write_variant(out: Path, name: str) -> Path:
    """Writes <out>/<name>/realtimeraytracer_torch with variant `name`'s
    edit; returns <out>/<name> (the PYTHONPATH entry)."""
    source, (old, new) = VARIANTS[name]
    root = out / name
    if root.exists():
        shutil.rmtree(root)
    dst = root / PKG.name
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "assets").symlink_to(PKG.parent / "assets")
    path = dst / "csrc" / source
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: the stretch it replaces in {source} is gone or ambiguous")
    path.write_text(text.replace(old, new))
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
