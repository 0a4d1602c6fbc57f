"""One rank of the gloo process group that tests/test_torch_sharding.py
starts: the port's sharded paths (realtimeraytracer_torch/parallel/) on
CPU tensors, and the single-device counterparts on rank 0.

Run as: python tests/_torch_sharding_worker.py <rank> <world> <port> <dir>

<dir>/scene.npz holds the compiled scene's leaves (from_numpy_leaves).
Writes <dir>/rank<rank>.npz (arrays) and <dir>/rank<rank>.json (the
collective logs, ray counts, losses) and prints "RANK <rank> OK".
Imports torch and the port only.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

rank, world, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
    os.environ.pop(var, None)

import torch.distributed as dist  # noqa: E402

import realtimeraytracer_torch as rt  # noqa: E402
from realtimeraytracer_torch import scenes  # noqa: E402
from realtimeraytracer_torch.diff import optimize as opt  # noqa: E402
from realtimeraytracer_torch.ops.camera_rays import generate_rays  # noqa: E402
from realtimeraytracer_torch.parallel import sharded  # noqa: E402
from realtimeraytracer_torch.parallel.mesh import initialize_multihost, make_ray_mesh  # noqa: E402
from realtimeraytracer_torch.render import megakernel  # noqa: E402
from realtimeraytracer_torch.render.backends import make_backend  # noqa: E402
from realtimeraytracer_torch.render.pipeline import render_pipeline_gpu  # noqa: E402
from realtimeraytracer_torch.render.wavefront import trace_paths  # noqa: E402
from realtimeraytracer_torch.scene.gpu_scene import from_numpy_leaves  # noqa: E402

arrays, info = {}, {}

# initialize_multihost with no kwargs and no launcher environment: no-op.
initialize_multihost()
info["noop_without_launcher"] = not dist.is_initialized()
initialize_multihost(backend="gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                     rank=rank)
initialize_multihost(backend="gloo", init_method="tcp://127.0.0.1:1", world_size=world, rank=rank)
info["world"] = dist.get_world_size()
mesh = make_ray_mesh(device="cpu")
single = make_ray_mesh(1, device="cpu")

with np.load(os.path.join(out_dir, "scene.npz")) as z:
    gpu = from_numpy_leaves(dict(z))
CFG = rt.RenderConfig(width=32, height=32, primary_rays=1, shadow_rays=1, denoise_iterations=1,
                      jitter=False, use_bvh=False, shadow_ray_margin=0.02)
camera = scenes.cornell_box().camera
frame = camera.viewport_frame(32, 32)

# Rays each rank traces: the backends' closest and occlusion queries.
rays = {"closest": 0, "occluded": 0}
make = megakernel.make_backend


def counting_backend(g, c):
    be = make(g, c)

    def counted(kind, fn):
        def call(o, *a, **k):
            rays[kind] += o.shape[0]
            return fn(o, *a, **k)
        return call

    return be._replace(closest=counted("closest", be.closest),
                       occluded=counted("occluded", be.occluded))


# ---- the frame, sharded and (rank 0) on one device ------------------------------
megakernel.make_backend = counting_backend
arrays["frame"] = sharded.render_pipeline_sharded(gpu, frame, CFG, mesh).numpy()
info["rays"] = dict(rays)
if rank == 0:
    rays.update(closest=0, occluded=0)
    arrays["frame_single"] = render_pipeline_gpu(gpu, frame, CFG).numpy()
    info["rays_single"] = dict(rays)
megakernel.make_backend = make
info["frame_log"] = list(mesh.log)

# ---- the halo-exchanged denoise: 64x64, 4 iterations, 16 rows a rank -----------
cfg_d = CFG.replace(width=64, height=64, denoise_iterations=4)
frame64 = camera.viewport_frame(64, 64)
mesh.log.clear()
arrays["halo"] = sharded.render_pipeline_sharded(gpu, frame64, cfg_d, mesh).numpy()
info["halo_log"] = list(mesh.log)
if rank == 0:
    arrays["halo_single"] = render_pipeline_gpu(gpu, frame64, cfg_d).numpy()

# ---- one wavefront sample ------------------------------------------------------
cfg_w = CFG.replace(max_bounces=2, denoise_iterations=0)
o, d = generate_rays(frame, 32, 32, jitter=False)
seed = torch.arange(o.shape[0])
with torch.inference_mode():
    arrays["wavefront"] = mesh.all_gather_rows(
        sharded.wavefront_sample_sharded(gpu, cfg_w, o, d, seed, mesh)).numpy()
    if rank == 0:
        arrays["wavefront_single"] = trace_paths(gpu, cfg_w, o, d, seed).numpy()

# ---- one primary sample through sharded_shade -----------------------------------
with torch.inference_mode():
    rad = sharded.sharded_shade(gpu, CFG, o, d, seed, mesh)
    arrays["shade"] = np.concatenate([mesh.all_gather_rows(x).numpy() for x in rad], 1)
    if rank == 0:
        one = megakernel.shade_sample(gpu, CFG, o, d, seed, make_backend(gpu, CFG))
        arrays["shade_single"] = np.concatenate([x.numpy() for x in one], 1)

# ---- the training step: 4 ranks and one, from the same state --------------------
with torch.no_grad():
    target = megakernel.shade_sample(gpu, CFG, o, d, seed, make_backend(gpu, CFG)).analytic
wrong = dataclasses.replace(gpu, obj_color=gpu.obj_color * 0.7)
for name, m in (("step", mesh), ("step_single", single)):
    params = {"obj_color": wrong.obj_color.clone().requires_grad_()}
    state = opt.TrainState(params, opt.adam(params, 1e-2))
    state, loss = opt.make_train_step(CFG, m, state.optimizer)(state, wrong, o, d, seed, target)
    arrays[name] = state.params["obj_color"].detach().numpy()
    info[name + "_loss"] = float(loss)
_, info["fit_losses"] = opt.fit(wrong, CFG, o, d, seed, target, mesh=mesh, steps=3,
                                learning_rate=5e-2)

np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(info, f)
dist.destroy_process_group()
print(f"RANK {rank} OK", flush=True)
