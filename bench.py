"""Benchmark: 3DGS forward (and fwd+bwd) throughput on one GPU.

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "extra"}.

Baseline (BASELINE.md): reference mesh-shader raster renders the 6.13M-splat
bicycle scene at 587 FPS @ 1465x766 on an RTX 6000 Ada = 658.6 Mpixel/s.

The render's overflow flag (slot windows truncated) is recorded in the JSON,
not asserted. Requires a GPU: on any other backend it exits non-zero.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

from vk_gaussian_splatting_tpu.config import RenderConfig
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs
from vk_gaussian_splatting_tpu.scene.cameras import look_at
from vk_gaussian_splatting_tpu.scene.golden import golden_tiled
from vk_gaussian_splatting_tpu.scene.splat_set import random_splats
from vk_gaussian_splatting_tpu.utils.compile_cache import enable_compile_cache

BASELINE_MPIX_S = 587 * 1465 * 766 / 1e6  # 658.6


def make_scene(n_splats: int):
    """Synthetic scene matching trained-scene screen statistics: ~97% of a
    converged 3DGS model's splats are sub-8-px on screen with a few percent
    mid-size and rare large background blobs (the INRIA scenes the reference
    benches, benchmark.py:419-433). Built on the device."""
    import dataclasses as dc

    k = jax.random.key(0)
    ks, km, kl = jax.random.split(k, 3)
    n_s, n_m = int(n_splats * 0.969), int(n_splats * 0.025)
    n_l = n_splats - n_s - n_m
    small = random_splats(ks, n_s, sh_degree=3, extent=4.0,
                          scale_range=(-7.0, -5.0))
    mid = random_splats(km, n_m, sh_degree=3, extent=4.0,
                        scale_range=(-5.0, -3.5))
    large = random_splats(kl, n_l, sh_degree=3, extent=4.0,
                          scale_range=(-3.5, -2.0))
    fields = {}
    for f in ("means", "scales", "quats", "opacities", "sh_dc", "sh_rest"):
        fields[f] = jnp.concatenate([getattr(s, f)
                                     for s in (small, mid, large)])
    return dc.replace(small, **fields).prepare()


# frames per dispatch: one on-device lax.scan over FRAMES jittered cameras
# amortizes the per-dispatch host overhead and keeps a frame's time from
# resting on one host clock reading
FRAMES = 8


def time_stats(fn, *args, iters=6, warmup=2):
    """(min, median, max) seconds per frame over `iters` timed dispatches
    after `warmup` discarded ones; each dispatch ends in block_until_ready.
    The min is the headline; median and max show the spread."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2] if len(times) % 2 else (
        times[len(times) // 2 - 1] + times[len(times) // 2]) / 2
    return times[0] / FRAMES, med / FRAMES, times[-1] / FRAMES


def time_fn(fn, *args, iters=6, warmup=2):
    return time_stats(fn, *args, iters=iters, warmup=warmup)[0]


def jitter(c, i):
    # per-frame camera nudge: keeps the scan body un-CSE-able without
    # changing the workload
    return dataclasses.replace(
        c, viewmat=c.viewmat.at[0, 3].add(i.astype(jnp.float32) * 1e-4))


def scan_pipe(pipe, cfg):
    """jit: sum-of-images + OR-of-overflow over FRAMES jittered cameras."""
    @jax.jit
    def fn(p, c):
        def body(carry, i):
            o = pipe(p, jitter(c, i), cfg)
            s, ov = carry
            return (s + jnp.sum(o.image), ov | o.overflow), None
        (s, ov), _ = jax.lax.scan(body, (0.0, jnp.bool_(False)),
                                  jnp.arange(FRAMES))
        return s, ov
    return fn


def fwd_bwd_fn(cfg):
    @jax.jit
    def fwd_bwd(p, c):
        def loss(pp):
            @jax.checkpoint
            def frame_loss(pp_, i):
                # remat per frame: without it the scan keeps every frame's
                # buffers for the backward
                o = render_3dgs(pp_, jitter(c, i), cfg)
                return jnp.sum(o.image ** 2)

            def body(carry, i):
                return carry + frame_loss(pp, i), None
            s, _ = jax.lax.scan(body, 0.0, jnp.arange(FRAMES))
            return s
        return jax.grad(loss)(p)
    return fwd_bwd


def card_name():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=30)
    return r.stdout.strip().splitlines()[0]


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    card = card_name()
    print(f"device: {dev.device_kind}; nvidia-smi: {card}", flush=True)
    enable_compile_cache()
    t_start = time.perf_counter()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "2400"))
    n_splats = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    cfg = RenderConfig(width=1920, height=1080, sh_degree=3)
    prepared = make_scene(n_splats)
    cam = look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], cfg.width,
                  cfg.height, fov_y_rad=0.9)

    def cfg_with(**raster_kw):
        return cfg.replace(raster=dataclasses.replace(cfg.raster,
                                                      **raster_kw))

    fwd = scan_pipe(render_3dgs, cfg)
    overflow = bool(fwd(prepared, cam)[1])
    dt_fwd, dt_fwd_med, dt_fwd_max = time_stats(fwd, prepared, cam)
    dt_fwd_bwd = time_fn(fwd_bwd_fn(cfg), prepared, cam, iters=3)

    mpix_s = cfg.width * cfg.height / dt_fwd / 1e6
    mpix_s_train = cfg.width * cfg.height / dt_fwd_bwd / 1e6

    extra = {
        "overflow": overflow,
        "fwd_ms": round(dt_fwd * 1e3, 3),
        "fwd_ms_median": round(dt_fwd_med * 1e3, 3),
        "fwd_ms_max": round(dt_fwd_max * 1e3, 3),
        "fwd_bwd_ms": round(dt_fwd_bwd * 1e3, 3),
        "fwd_bwd_mpix_s": round(mpix_s_train, 2),
        "fps": round(1.0 / dt_fwd, 2),
        "n_splats": n_splats,
        "device": dev.device_kind,
        "card": card,
    }

    # per-pipeline frame times (the reference's per-pipeline tables,
    # doc/rasterization_of_3dgut.md:108-119 /
    # doc/ray_tracing_3d_gaussians.md:150-162); packed = the fp16-analog
    # inference tier. Each variant is independent: a failure or a blown
    # wall-clock budget records a marker instead of killing the artifact.
    if not os.environ.get("BENCH_SKIP_EXTRAS"):
        import vk_gaussian_splatting_tpu.render.pipelines as pl

        variants = {
            "3dgs_packed": (render_3dgs, cfg_with(pair_format="packed")),
            "3dgut": (pl.render_3dgut, cfg),
            "3dgrt": (pl.render_3dgrt, cfg),
            "3dgut_packed": (pl.render_3dgut, cfg_with(pair_format="packed")),
        }
        for name, (pipe, c) in variants.items():
            if time.perf_counter() - t_start > budget_s:
                extra[name + "_ms"] = "skipped:budget"
                continue
            try:
                one = scan_pipe(pipe, c)
                dt = time_fn(one, prepared, cam, iters=2, warmup=1)
                extra[name + "_ms"] = round(dt * 1e3, 3)
                extra[name + "_overflow"] = bool(one(prepared, cam)[1])
            except Exception as e:  # noqa: BLE001 — record, don't die
                extra[name + "_ms"] = f"error:{type(e).__name__}"

        # trained-statistics scenes: grid-replicated golden corpus at the
        # headline size AND at the reference's bicycle scale (6.13M splats,
        # README.md:132-138 / BASELINE.md)
        for tag, g_n in (("golden", n_splats), ("golden_6m", 6_130_000)):
            if time.perf_counter() - t_start > budget_s:
                extra[tag + "_fwd_ms"] = "skipped:budget"
                continue
            try:
                g_scene, g_eye, g_at = golden_tiled(g_n)
                g_prep = g_scene.prepare()
                g_cam = look_at(g_eye, g_at, [0, 1, 0], cfg.width,
                                cfg.height, fov_y_rad=0.9)
                g_fwd = scan_pipe(render_3dgs, cfg)
                extra[tag + "_fwd_ms"] = round(
                    time_fn(g_fwd, g_prep, g_cam, iters=2, warmup=1) * 1e3, 3)
                extra[tag + "_overflow"] = bool(g_fwd(g_prep, g_cam)[1])
                extra[tag + "_n_splats"] = int(g_prep.means.shape[0])
                del g_prep, g_fwd
            except Exception as e:  # noqa: BLE001
                extra[tag + "_fwd_ms"] = f"error:{type(e).__name__}"

    print(json.dumps({
        "metric": "3dgs_raster_fwd_1080p_1M_splats",
        "value": round(mpix_s, 2),
        "unit": "Mpixel/s",
        "vs_baseline": round(mpix_s / BASELINE_MPIX_S, 4),
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
