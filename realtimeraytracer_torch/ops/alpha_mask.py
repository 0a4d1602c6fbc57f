"""Conservative per-triangle barycentric alpha masks (build time, NumPy).

Counterpart of realtimeraytracer_tpu/ops/alpha_mask.py (host NumPy, the
same arithmetic): ``build_face_masks_np`` gives every alpha-mapped
triangle a 64-bit mask over an 8x8 grid of its (u, v) barycentric domain,
bit = 0 only when every texel the bilinear sampler could touch inside
that cell has alpha < threshold; ``pack_amask_np`` lays the masks out as
(C, 2, 128) int32 panels beside the traversal coefficient panels.  The
traversal kernels (csrc/trace_v7.cu, trace_v9.cu, trace_v8.cu) test the
mask in their accept test, so hits in definitely-transparent cells are
rejected inside the traversal instead of by a round of the re-trace
ladder (render/alpha.py).  Cells that are not definitely transparent keep
the ladder's exact texture evaluation.  The result equals the unmasked
ladder's except for rays that exhaust the ladder: with masks they resolve
further (ROADMAP queue C).

Conservativeness: bilinear interpolation is a convex combination of the
four wrapped neighbour texels, so its value is at most the greatest texel
of the query footprint; a cell's footprint is bounded by the texel box of
its padded uv parallelogram plus one texel, which ``_rect_max`` bounds with
a max pyramid.  The cell is padded by 1/256 in barycentric units.
"""

from __future__ import annotations

import numpy as np

GRID = 8                 # cells per barycentric axis (64 bits total)
PAD = 1.0 / 256.0        # barycentric cell padding (f32-noise safety)


def _max_pyramid(a: np.ndarray) -> list[np.ndarray]:
    """Max pyramid of a 2-D array; level L cell (cy, cx) bounds the max
    over texels [cy*2^L, (cy+1)*2^L) x [cx*2^L, ...), -inf past the true
    extent (padding can only shrink a max bound, never inflate it)."""
    levels = [a.astype(np.float32)]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        h, w = levels[-1].shape
        h2, w2 = (h + 1) // 2, (w + 1) // 2
        p = np.full((h2 * 2, w2 * 2), -np.inf, np.float32)
        p[:h, :w] = levels[-1]
        levels.append(np.maximum(
            np.maximum(p[0::2, 0::2], p[0::2, 1::2]),
            np.maximum(p[1::2, 0::2], p[1::2, 1::2])))
    return levels


def _seg_max(pyr, y0, y1, x0, x1):
    """Max over texel rect [y0, y1] x [x0, x1] (inclusive, in-extent).

    Vectorized over query arrays: pick the level where the rect spans
    <= 2 cells per axis, take the max of the 4 covering cells."""
    h, w = pyr[0].shape
    span = np.maximum(x1 - x0, y1 - y0)
    out = np.full(x0.shape, -np.inf, np.float32)
    s = np.maximum(span, 1)
    lvl = np.ceil(np.log2(s + 1e-9)).astype(np.int32)
    lvl = np.clip(lvl, 0, len(pyr) - 1)
    for L in range(len(pyr)):
        m = lvl == L
        if not m.any():
            continue
        hl, wl = pyr[L].shape
        cy0, cy1 = y0[m] >> L, y1[m] >> L
        cx0, cx1 = x0[m] >> L, x1[m] >> L
        cy0 = np.clip(cy0, 0, hl - 1); cy1 = np.clip(cy1, 0, hl - 1)
        cx0 = np.clip(cx0, 0, wl - 1); cx1 = np.clip(cx1, 0, wl - 1)
        p = pyr[L]
        out[m] = np.maximum(
            np.maximum(p[cy0, cx0], p[cy0, cx1]),
            np.maximum(p[cy1, cx0], p[cy1, cx1]))
    return out


def _rect_max(pyr, y0, y1, x0, x1):
    """Max over the REPEAT-WRAPPED texel rect [y0, y1] x [x0, x1]
    (inclusive, arbitrary ints).  Each axis wraps into <= 2 in-extent
    segments; full-extent spans clamp to the whole axis."""
    h, w = pyr[0].shape

    def segments(lo, hi, n):
        full = (hi - lo + 1) >= n
        lo_w = np.where(full, 0, np.mod(lo, n))
        hi_w = np.where(full, n - 1, np.mod(hi, n))
        wraps = ~full & (hi_w < lo_w)
        # segment A: [lo_w, hi_w] when not wrapping else [lo_w, n-1]
        a0, a1 = lo_w, np.where(wraps, n - 1, hi_w)
        # segment B: only live when wrapping: [0, hi_w]
        b0, b1 = np.zeros_like(lo_w), np.where(wraps, hi_w, a1)
        b0 = np.where(wraps, 0, a0)
        return (a0, a1), (b0, b1)

    (ya0, ya1), (yb0, yb1) = segments(y0, y1, h)
    (xa0, xa1), (xb0, xb1) = segments(x0, x1, w)
    m = _seg_max(pyr, ya0, ya1, xa0, xa1)
    m = np.maximum(m, _seg_max(pyr, ya0, ya1, xb0, xb1))
    m = np.maximum(m, _seg_max(pyr, yb0, yb1, xa0, xa1))
    m = np.maximum(m, _seg_max(pyr, yb0, yb1, xb0, xb1))
    return m


def build_face_masks_np(uv0, uv1, uv2, tex_id, atlas_alpha, tex_size,
                        threshold: float) -> np.ndarray:
    """Per-face 64-bit conservative alpha masks.

    uv0/1/2: (F, 2) f32 per-corner uvs (sorted face order); tex_id: (F,)
    i32 opacity-texture id (-1 = none -> all-ones mask); atlas_alpha:
    (T, S, S) f32 alpha channel of the padded atlas; tex_size: (T, 2) i32
    true (h, w).  Returns (F, 2) uint32 (little word first: bit b of the
    mask is word b>>5, bit b&31; b = iy*GRID + ix over the (u, v) grid).
    """
    f = uv0.shape[0]
    masks = np.full((f, 2), 0xFFFFFFFF, np.uint64).astype(np.uint32)
    alpha_faces = np.where(np.asarray(tex_id) >= 0)[0]
    if alpha_faces.size == 0:
        return masks

    # Cell corner offsets in barycentric units, padded.
    ix = np.arange(GRID, dtype=np.float32)
    u_lo = ix / GRID - PAD
    u_hi = (ix + 1) / GRID + PAD
    cu_lo = np.tile(u_lo, GRID)          # (64,) cell u-low,  x-major
    cu_hi = np.tile(u_hi, GRID)
    cv_lo = np.repeat(u_lo, GRID)        # (64,) cell v-low
    cv_hi = np.repeat(u_hi, GRID)
    # Cells fully outside the triangle domain (u + v <= 1 after padding)
    # can never be consulted by the kernel's accept test: bit 0.
    inside = (cu_lo + cv_lo) <= 1.0 + 2 * PAD

    for t in np.unique(np.asarray(tex_id)[alpha_faces]):
        sel = alpha_faces[np.asarray(tex_id)[alpha_faces] == t]
        h, w = int(tex_size[t, 0]), int(tex_size[t, 1])
        pyr = _max_pyramid(atlas_alpha[t, :h, :w])
        a0 = uv0[sel].astype(np.float64)           # (n, 2)
        e1 = (uv1[sel] - uv0[sel]).astype(np.float64)
        e2 = (uv2[sel] - uv0[sel]).astype(np.float64)

        # uv bbox of each (face, cell) padded parallelogram: affine in
        # (u, v), so extremes sit at the 4 corner combinations.
        def corner(cu, cv):
            return (a0[:, None, :] + cu[None, :, None] * e1[:, None, :]
                    + cv[None, :, None] * e2[:, None, :])   # (n, 64, 2)

        cs = [corner(cu_lo, cv_lo), corner(cu_lo, cv_hi),
              corner(cu_hi, cv_lo), corner(cu_hi, cv_hi)]
        uv_min = np.minimum(np.minimum(cs[0], cs[1]),
                            np.minimum(cs[2], cs[3]))
        uv_max = np.maximum(np.maximum(cs[0], cs[1]),
                            np.maximum(cs[2], cs[3]))

        # Texel footprint of the bilinear sampler over the uv bbox
        # (texture.sample_atlas: x = u*w - 0.5, neighbors floor(x) and
        # floor(x)+1, repeat wrap).
        x0 = np.floor(uv_min[..., 0] * w - 0.5).astype(np.int64)
        x1 = np.floor(uv_max[..., 0] * w - 0.5).astype(np.int64) + 1
        y0 = np.floor(uv_min[..., 1] * h - 0.5).astype(np.int64)
        y1 = np.floor(uv_max[..., 1] * h - 0.5).astype(np.int64) + 1

        mx = _rect_max(pyr, y0.reshape(-1), y1.reshape(-1),
                       x0.reshape(-1), x1.reshape(-1)).reshape(-1, 64)
        bits = (mx >= threshold) & inside[None, :]          # (n, 64)
        words = np.zeros((len(sel), 2), np.uint32)
        for b in range(64):
            words[:, b >> 5] |= bits[:, b].astype(np.uint32) << (b & 31)
        masks[sel] = words
    return masks


def pack_amask_np(masks: np.ndarray, num_blocks: int,
                  slots: np.ndarray | None = None) -> np.ndarray:
    """(F, 2) uint32 face masks -> (C, 2, 128) int32 panels aligned with
    the traversal coefficient panels (scene/panels.py layout:
    slot s lives at panel s//128, lane s%128).

    slots: optional (C*128,) int64 repacked-slot -> sorted-face map
    (ops/repack.py), -1 for pad lanes; None = identity (v7/v8 panels).
    Pad lanes get mask 0 (they are degenerate and can never pass the
    intersection test anyway)."""
    total = num_blocks * 128
    out = np.zeros((total, 2), np.uint32)
    if slots is None:
        n = min(total, masks.shape[0])
        out[:n] = masks[:n]
    else:
        # slots covers ng*32 lanes; panel padding past the last group
        # keeps mask 0 (degenerate pads can never pass anyway).
        s = slots[: min(total, len(slots))]
        idx = np.nonzero(s >= 0)[0]
        out[idx] = masks[s[idx]]
    return out.reshape(num_blocks, 128, 2).transpose(0, 2, 1).astype(
        np.int64).astype(np.int32)
