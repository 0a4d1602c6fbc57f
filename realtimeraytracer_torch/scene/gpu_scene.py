"""TorchScene: the compiled, device-resident scene.

Counterpart of realtimeraytracer_tpu/scene/gpu_scene.py (``GPUScene``): the
same leaves, names, shapes and dtypes, as tensors, including the v9
repacked panels, the texture atlas and its packed-neighbour twin, the mip
chain of the atlas with its packed twin and the per-face uv density (when
the scene was compiled with mips), the alpha masks of both panel sets, the
BVH's refit ranges, the opaque/alpha panel split of ``alpha_split`` and the
shared-geometry instancing tables (``instanced``).  One leaf is the
port's own: ``pallas_amask_alp``, the alpha subset's masks packed for its
own panels.  A JAX ``GPUScene`` carries its seven split leaves across
(``from_numpy_leaves``) without it; the split then builds it from
``pallas_amask`` (``alpha_subset_amask``), and never traces the alpha
subset with the whole scene's masks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TorchScene:
    # triangle soup (world space; light triangles first)
    vertices: torch.Tensor      # (V, 3) f32
    normals: torch.Tensor       # (V, 3) f32
    uvs: torch.Tensor           # (V, 2) f32
    faces: torch.Tensor         # (F, 3) i32, in BVH order when a BVH exists
    face_obj: torch.Tensor      # (F,) i32
    # object table (lights first, then meshes, then spheres)
    obj_color: torch.Tensor     # (O, 3) f32, linear
    obj_specular: torch.Tensor  # (O,) f32; roughness = 1 - specular
    obj_metallic: torch.Tensor  # (O,) f32
    obj_is_light: torch.Tensor  # (O,) i32
    obj_tex: torch.Tensor       # (O, 4) i32 texture ids [color, specular,
                                #   metallic, opacity], -1 = constant
    # analytic spheres
    sph_center: torch.Tensor    # (S, 3) f32
    sph_radius: torch.Tensor    # (S,) f32
    sph_obj: torch.Tensor       # (S,) i32
    # light triangles
    lt_v0: torch.Tensor         # (LT, 3) f32
    lt_v1: torch.Tensor
    lt_v2: torch.Tensor
    lt_color: torch.Tensor      # (LT, 3) f32
    lt_intensity: torch.Tensor  # (LT,) f32
    lt_two_sided: torch.Tensor  # (LT,) bool
    lt_valid: torch.Tensor      # (LT,) bool
    # sun and environment
    sun_direction: torch.Tensor  # (3,) f32, toward the light
    sun_color: torch.Tensor      # (3,) f32
    sun_intensity: torch.Tensor  # () f32
    hdri: torch.Tensor           # (He, We, 3) f32, sRGB-encoded
    env_color: torch.Tensor      # (3,) f32
    # LTC lookup tables
    ltc1: torch.Tensor           # (64, 64, 4) f32
    ltc2: torch.Tensor
    # LBVH (single-node dummies when not built)
    bvh_node_min: torch.Tensor   # (N, 3) f32
    bvh_node_max: torch.Tensor
    bvh_node_skip: torch.Tensor  # (N,) i32
    bvh_node_first: torch.Tensor
    bvh_node_count: torch.Tensor
    bvh_tri_v0: torch.Tensor     # (T, 3) f32, BVH-sorted
    bvh_tri_v1: torch.Tensor
    bvh_tri_v2: torch.Tensor
    bvh_tri_id: torch.Tensor     # (T,) i32
    # v7 traversal panels (scene/panels.py)
    pallas_panels: torch.Tensor | None = None   # (CB, 12, 128) f32
    pallas_cl_min: torch.Tensor | None = None   # (CB*4, 3) f32
    pallas_cl_max: torch.Tensor | None = None
    # v9 SAH-repacked panels (ops/repack.py), for scenes of at most
    # RESIDENT_CB blocks: sorted id = slot id - q_group_off[slot // 32]
    q_panels: torch.Tensor | None = None        # (Cq, 12, 128) f32
    q_cl_min: torch.Tensor | None = None        # (Cq*4, 3) f32
    q_cl_max: torch.Tensor | None = None
    q_group_off: torch.Tensor | None = None     # (Cq*4,) i32
    vert_obj: torch.Tensor | None = None        # (V,) i32
    lt_obj: torch.Tensor | None = None          # (LT,) i32
    # Texture atlas: textures padded to (S, S), true (h, w) in tex_size;
    # T = 0 when the scene has none.  tex_atlas_packed carries each
    # texel's 2x2 bilinear footprint (one gather per fetch).
    tex_atlas: torch.Tensor | None = None         # (T, S, S, 4) f32
    tex_size: torch.Tensor | None = None          # (T, 2) i32
    tex_atlas_packed: torch.Tensor | None = None  # (T, S, S, 16) f32
    # Mip chain of the atlas (ops/texture.py::build_mip_atlas_np): level k
    # at rows [2S - 2S/2^k, ...); its packed twin; per face sqrt(uv area /
    # world area) for the LOD.  None unless compiled with mip_textures.
    tex_mip_atlas: torch.Tensor | None = None         # (T, 2S, S, 4) f32
    tex_mip_atlas_packed: torch.Tensor | None = None  # (T, 2S, S, 16) f32
    face_uv_density: torch.Tensor | None = None       # (F,) f32
    # Conservative 8x8 barycentric alpha masks (ops/alpha_mask.py), laid
    # out like the v7/v8 panels and, by repacked slot, like the v9 panels.
    pallas_amask: torch.Tensor | None = None      # (CB, 2, 128) i32
    q_amask: torch.Tensor | None = None           # (Cq, 2, 128) i32
    # Opaque/alpha panel split (scene/scene.py; render/alpha.py's two-phase
    # occlusion): the v7/v8 panels of the opaque and of the alpha-mapped
    # triangles, each subset in sorted order; alpha_tri_id maps a sorted id
    # of the alpha subset to the scene's; pallas_amask_alp, the alpha
    # subset's masks laid out like its panels, is the port's own leaf.
    pallas_panels_opq: torch.Tensor | None = None  # (CBo, 12, 128) f32
    pallas_cl_min_opq: torch.Tensor | None = None  # (CBo*4, 3) f32
    pallas_cl_max_opq: torch.Tensor | None = None
    pallas_panels_alp: torch.Tensor | None = None  # (CBa, 12, 128) f32
    pallas_cl_min_alp: torch.Tensor | None = None  # (CBa*4, 3) f32
    pallas_cl_max_alp: torch.Tensor | None = None
    alpha_tri_id: torch.Tensor | None = None       # (A,) i32
    pallas_amask_alp: torch.Tensor | None = None   # (CBa, 2, 128) i32
    # Per BVH node, its [start, end) range of sorted triangles: the
    # device-side refit's range reductions (ops/refit.py).
    bvh_node_tri_start: torch.Tensor | None = None  # (N,) i32
    bvh_node_tri_end: torch.Tensor | None = None    # (N,) i32
    # Shared-geometry instancing (scene/scene.py::_compile_instanced).  When
    # set, vertices, normals, uvs and faces are mesh-space pools shared by
    # every instance; the v8 kernel traces each (instance, super) pair in
    # mesh space and the surface resolver applies the instance transform.
    inst_inv: torch.Tensor | None = None        # (I, 12) f32 world->mesh [R|t]
    inst_fwd: torch.Tensor | None = None        # (I, 12) f32 mesh->world [R|t]
    inst_obj: torch.Tensor | None = None        # (I,) i32 object-table row
    pair_panel: torch.Tensor | None = None      # (PP, 8, 128) f32 world boxes
                                                #   of the (instance, super) pairs
    pair_tab: torch.Tensor | None = None        # (PP*128, 4) i32 rows [inst,
                                                #   blk_panel row, block base, valid]
    blk_panel: torch.Tensor | None = None       # (NSUP, 8, 128) f32 mesh-space
                                                #   block boxes per super
    pair_mesh_aabb: torch.Tensor | None = None  # (PP*128, 6) f32 mesh-space
                                                #   super box per pair (refit)

    @property
    def instanced(self) -> bool:
        return self.inst_inv is not None

    @property
    def has_textures(self) -> bool:
        """Whether the scene has textures (then tex_atlas_packed, which the
        samplers read, is there too)."""
        return self.tex_atlas is not None and self.tex_atlas.shape[0] > 0

    @property
    def has_mips(self) -> bool:
        """Whether the scene carries the mip leaves that the mip path reads."""
        return (self.tex_mip_atlas is not None and self.tex_mip_atlas.shape[0] > 0
                and self.tex_mip_atlas_packed is not None
                and self.face_uv_density is not None)

    @property
    def mip_levels(self) -> int:
        """Levels of the mip chain: S = 2^n gives n + 1 (1 for S = 1)."""
        return max(1, self.tex_mip_atlas.shape[2].bit_length())

    @property
    def has_alpha_split(self) -> bool:
        """Whether the compile built the opaque/alpha panel split."""
        return self.pallas_panels_opq is not None and self.alpha_tri_id is not None

    @property
    def has_bvh(self) -> bool:
        return self.bvh_node_min.shape[0] > 1

    @property
    def num_tris(self) -> int:
        return self.faces.shape[0]

    @property
    def num_light_tris(self) -> int:
        return self.lt_v0.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def to(self, device: str | torch.device) -> "TorchScene":
        """A copy with every leaf on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None})

    def detach(self) -> "TorchScene":
        """The scene with no leaf in the autograd graph: what the traversal
        kernels and their twins are handed, as the JAX package hands them
        ``stop_gradient(gpu)``.  Itself when no leaf requires grad (every
        frame), else a copy with the gradient-carrying leaves detached
        (views of the same storage)."""
        carried = {f.name: getattr(self, f.name).detach() for f in dataclasses.fields(self)
                   if getattr(self, f.name) is not None and getattr(self, f.name).requires_grad}
        return dataclasses.replace(self, **carried) if carried else self


LEAF_NAMES = tuple(f.name for f in dataclasses.fields(TorchScene))


def from_numpy_leaves(leaves: dict[str, np.ndarray],
                      device: str | torch.device = "cpu") -> TorchScene:
    """Build a TorchScene from a compiled scene's leaves as NumPy arrays —
    e.g. the JAX package's ``GPUScene._asdict()`` passed through
    ``np.asarray`` — so both packages can render one compiled scene,
    instanced ones included.  Leaves this port does not use are ignored."""
    kw = {name: torch.from_numpy(np.array(leaves[name], copy=True, order="C"))
          for name in LEAF_NAMES if leaves.get(name) is not None}
    return TorchScene(**kw).to(device)


def alpha_subset_amask(gpu: TorchScene) -> torch.Tensor:
    """The alpha subset's masks, (CBa, 2, 128) int32: the scene's own
    ``pallas_amask_alp``, or, for a scene carried across from the JAX
    package (which has no such leaf), each alpha triangle's mask moved
    from its block and lane of ``pallas_amask`` to those of the subset
    (pad lanes 0, as ``ops/alpha_mask.py::pack_amask_np`` packs them)."""
    if gpu.pallas_amask_alp is not None:
        return gpu.pallas_amask_alp
    ids = gpu.alpha_tri_id.long()
    out = torch.zeros((gpu.pallas_panels_alp.shape[0], 2, 128), dtype=torch.int32,
                      device=gpu.pallas_amask.device)
    k = torch.arange(ids.shape[0], device=ids.device)
    out[k // 128, :, k % 128] = gpu.pallas_amask[ids // 128, :, ids % 128]
    return out
