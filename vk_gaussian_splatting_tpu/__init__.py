"""Differentiable 3D Gaussian Splatting framework in JAX.

A from-scratch JAX / Pallas re-design of the capabilities of
nvpro-samples/vk_gaussian_splatting (see SURVEY.md): 3DGS tile rasterization,
3DGUT unscented-transform rasterization, 3DGRT ray-traced Gaussians, hybrid and
stochastic variants — as pure, jittable, differentiable functions over a
multi-instance splat-set scene model, shardable across device meshes; the
tile blender runs as a Pallas-Triton kernel on NVIDIA GPUs.

Layout:
  io/        PLY / SPZ / .splat / OBJ / cameras.json / project JSON loaders
  scene/     SplatSet pytree, instances, cameras, lights, materials
  ops/       device math: SH, projection (EWA/UT), sort, tile binning,
             Pallas rasterizer fwd/bwd, ray marching, metrics
  render/    the six reference pipelines as pure functions of (scene, camera, cfg)
  parallel/  jax.sharding mesh policies (splat/tile/ray sharding)
  utils/     profiling (Timer grammar), memory statistics
  bench/     sequencer-compatible benchmark harness
"""

__version__ = "0.1.0"

from vk_gaussian_splatting_tpu.config import (
    CameraType,
    Pipeline,
    RasterConfig,
    RenderConfig,
    RtConfig,
    ShFormat,
    ShutterType,
    StochasticMode,
)
from vk_gaussian_splatting_tpu.scene.splat_set import SplatSet, PreparedSplats
from vk_gaussian_splatting_tpu.scene.cameras import Camera, look_at, make_camera

__all__ = [
    "Camera",
    "CameraType",
    "Pipeline",
    "PreparedSplats",
    "RasterConfig",
    "RenderConfig",
    "RtConfig",
    "ShFormat",
    "ShutterType",
    "SplatSet",
    "StochasticMode",
    "look_at",
    "make_camera",
]
