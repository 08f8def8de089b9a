"""GPU smoke run of the renderer's main path.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded path only

Phases (one card):
  1. device: require a GPU; print its kind, the JAX version and nvidia-smi's
     name and power limit.
  2. compile cache (utils/compile_cache.py).
  3. every response model at 256x192 through the Triton tile blender,
     against the XLA blender on the same card (images, aux picks, and
     gradients for the differentiable models); the lowered render() must
     contain the Triton kernel call.
  4. full width: the golden-tiled scene (~1M splats) at 1920x1080 through
     render() for 3DGS, 3DGUT, 3DGRT and packed 3DGS, each against the XLA
     blender; gradients of 3DGS and 3DGUT; memory analysis, peak memory
     and frame times.
  5. training: five train.train_step steps (fwd + bwd + Adam) on that scene
     at 1080p; the loss must be finite and fall.
  6. oracle at 256x192: rasterize_naive and the reference-shader emulation
     of tests/test_oracle.py.

With --cards 4 it runs render_3dgs_sharded and train_step_sharded over
four cards on the golden scene at 1080p, against a one-card render in the
same process.

Exits non-zero, with no result line, when JAX finds no GPU or any phase
fails. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Times printed here are smoke readings, not a benchmark.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# tolerances, kernel vs XLA blender (both f32). The kernel forms
# transmittance products as exp(cumsum(log q)) (<= ~1e-5 relative), and
# Triton's and XLA's exp/rsqrt may round differently, which can flip one
# pair's alpha across the 1/255 cutoff at a pixel (<= ~4e-3 of one color).
IMG_MAX_ABS = 5e-3
IMG_MEAN_ABS = 1e-5
PICK_MISMATCH = 2e-3      # fraction of pixels whose picked splat id differs
GRAD_MEDIAN_REL = 1e-3    # |dk - dx| / (|dx| + 1e-3 max|dx|), median
GRAD_P999_REL = 5e-2      # ... 99.9th percentile
# sharded vs one-card render: each band renders against pixel coordinates
# shifted by its row offset, and that rounding can flip a pair across the
# d <= 8 conic cutoff, where its alpha is still exp(-4) ~ 0.018 of opacity
SHARD_MAX_ABS = 5e-2
# oracle tolerances (f32 pipeline vs f64 references; tests/test_oracle.py)
ORACLE_MAX_ABS = 2e-3
ORACLE_MEAN_ABS = 1e-4


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*a):
    print(*a, flush=True)


def smi(query="name,power.limit"):
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def timed(fn, *args, iters=5):
    """(min, median) ms over iters calls, each ended by block_until_ready,
    after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts), float(np.median(ts))


def image_err(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), float(d.mean())


def grad_err(gk, gx):
    """(median, p99.9) relative error of the kernel's gradient leaves."""
    import jax
    k = np.concatenate([np.ravel(np.asarray(x, np.float64))
                        for x in jax.tree.leaves(gk)])
    x = np.concatenate([np.ravel(np.asarray(v, np.float64))
                        for v in jax.tree.leaves(gx)])
    check(np.isfinite(k).all(), "non-finite kernel gradient")
    rel = np.abs(k - x) / (np.abs(x) + 1e-3 * np.abs(x).max() + 1e-30)
    return float(np.median(rel)), float(np.percentile(rel, 99.9))


# ---------------------------------------------------------------------------
# blend inputs exactly as the pipelines build them
# ---------------------------------------------------------------------------

def blend_inputs(kind, prep, cam, cfg):
    """(bins, pix_ctx, st) for one pipeline, built with the pipelines' own
    helpers (render/pipelines.py)."""
    import jax.numpy as jnp

    from vk_gaussian_splatting_tpu.ops.projection import (
        project_splats,
        ut_project_splats,
    )
    from vk_gaussian_splatting_tpu.render import pipelines as pl
    from vk_gaussian_splatting_tpu.render.rays import build_tile_rays

    packed = kind.endswith("_packed")
    if kind.startswith("3dgs"):
        proj = project_splats(prep, cam, cfg)
        rows = (pl.gs_attr_rows_packed if packed else pl.gs_attr_rows)(proj)
        st = pl.raster_statics(cfg)
        if packed:
            st = dataclasses.replace(st, model="gs2dp")
        return pl.bin_for_cfg(proj, rows, cfg, 0), None, st
    proj = ut_project_splats(prep, cam, cfg)
    rows = (pl.gut_attr_rows_packed if packed else pl.gut_attr_rows)(
        prep, proj, cfg)
    pix = build_tile_rays(cam, cfg, sample_id=0)
    if kind == "3dgrt":
        radial = jnp.linalg.norm(prep.means - cam.position, axis=-1)
        st = pl._gut_statics(pl.raster_statics(cfg), cfg, packed,
                             alpha_clamp=cfg.rt.alpha_clamp,
                             min_transmittance=cfg.rt.min_transmittance)
        return pl.bin_for_cfg(proj, rows, cfg, 0, depth_override=radial), \
            pix, st
    st = pl._gut_statics(pl.raster_statics(cfg), cfg, packed)
    return pl.bin_for_cfg(proj, rows, cfg, 0), pix, st


def blended_image(kind, prep, cam, cfg, blender):
    """The pipeline's image with an explicit blender."""
    import jax.numpy as jnp

    from vk_gaussian_splatting_tpu.ops.tile_blend import (
        assemble_image,
        rasterize_bins,
    )
    bins, pix, st = blend_inputs(kind, prep, cam, cfg)
    out = rasterize_bins(bins, pix, jnp.full((1,), 1, jnp.int32), st,
                         blender=blender)
    return assemble_image(out, st.tiles_x, st.tiles_y, cfg.width,
                          cfg.height, cfg.background)[0]


PIPELINE = {"3dgs": 1, "3dgs_packed": 1, "3dgut": 4, "3dgrt": 2}


def pipeline_cfg(kind, cfg):
    from vk_gaussian_splatting_tpu.config import Pipeline
    c = cfg.replace(pipeline=Pipeline(PIPELINE[kind]))
    if kind.endswith("_packed"):
        c = c.replace(raster=dataclasses.replace(c.raster,
                                                 pair_format="packed"))
    return c


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_models():
    """Every response model at 256x192: kernel vs XLA blender."""
    import jax
    import jax.numpy as jnp

    from vk_gaussian_splatting_tpu.config import RenderConfig, StochasticMode
    from vk_gaussian_splatting_tpu.io.obj import ObjMaterial, ObjMesh
    from vk_gaussian_splatting_tpu.ops import rasterize_triton, rasterize_xla
    from vk_gaussian_splatting_tpu.ops.tile_blend import rasterize_bins
    from vk_gaussian_splatting_tpu.render import render
    from vk_gaussian_splatting_tpu.render.mesh_raster import (
        depth_limit_pix_ctx,
        mesh_bins,
        mesh_buffers_from_obj,
    )
    from vk_gaussian_splatting_tpu.render.shadows import ISO_LEVELS
    from vk_gaussian_splatting_tpu.scene.cameras import look_at
    from vk_gaussian_splatting_tpu.scene.splat_set import random_splats

    w, h = 256, 192
    cfg = RenderConfig(width=w, height=h, sh_degree=1)
    prep = random_splats(jax.random.key(0), 4000, sh_degree=1, extent=3.0,
                         scale_range=(-3.5, -1.5)).prepare()
    cam = look_at([0, 0, -10], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9)
    kern = rasterize_triton.blender()
    xla = rasterize_xla.rasterize_tiles
    seed = jnp.full((1,), 1, jnp.int32)

    # two overlapping quads for the triangle models
    pos = np.asarray([[-2, -2, 1], [2, -2, 1], [2, 2, 1], [-2, 2, 1],
                      [-1, -3, -0.5], [3, -1, 0.5], [1, 3, 0.5],
                      [-3, 1, -0.5]], np.float32)
    nrm = np.tile([0, 0, -1.0], (8, 1)).astype(np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    mesh = mesh_buffers_from_obj(ObjMesh(
        positions=pos, normals=nrm, indices=idx,
        mat_indices=np.asarray([0, 0, 1, 1], np.int32),
        materials=[ObjMaterial(diffuse=(1.0, 0.2, 0.2)),
                   ObjMaterial(diffuse=(0.2, 0.4, 1.0))]))

    def gs(st_kw=None, **cfg_kw):
        c = cfg.replace(**cfg_kw)
        bins, pix, st = blend_inputs("3dgs", prep, cam, c)
        return bins, pix, dataclasses.replace(st, **(st_kw or {}))

    def clip():
        bins, _, st = gs()
        xs = jnp.arange(w, dtype=jnp.float32)[None, :]
        limit = jnp.broadcast_to(9.0 + 2.0 * xs / w, (h, w))
        return bins, depth_limit_pix_ctx(limit, cfg), \
            dataclasses.replace(st, model="gs2d_clip")

    def tri(shading):
        c = cfg.replace(raster=dataclasses.replace(cfg.raster,
                                                   mesh_shading=shading))
        bins, st = mesh_bins(mesh, cam, c, 0)
        return bins, None, st

    cases = {
        "gs2d": (lambda: gs(), True),
        "gs2d_clip": (clip, True),
        "gs2dp": (lambda: blend_inputs("3dgs_packed", prep, cam, cfg), False),
        "gut3d": (lambda: blend_inputs("3dgut", prep, cam, cfg), True),
        "gut3d_radial": (lambda: blend_inputs("3dgrt", prep, cam, cfg), True),
        "gut3dp": (lambda: blend_inputs("3dgut_packed", prep, cam, cfg),
                   False),
        "tri2d": (lambda: tri("flat"), False),
        "tri2d_smooth": (lambda: tri("smooth"), False),
        "multi_iso": (lambda: gs({"multi_iso": True,
                                  "iso_thresholds": ISO_LEVELS}), False),
        "stochastic": (lambda: gs(stochastic=StochasticMode.SPLAT), False),
    }
    for name, (make, differentiable) in cases.items():
        bins, pix, st = make()
        run = jax.jit(lambda a, p, b=None: rasterize_bins(
            dataclasses.replace(bins, attrs=a), p, seed, st, blender=b),
                      static_argnums=2)
        ok_ = run(bins.attrs, pix, kern)
        ox = run(bins.attrs, pix, xla)
        img_max, img_mean = image_err(ok_[:, :4], ox[:, :4])
        if st.multi_iso:
            aux = f"iso-depth rows max abs {image_err(ok_[:, 4:], ox[:, 4:])[0]:.3e}"
            pick = 0.0
        else:
            ids_k = np.asarray(ok_[:, 5] + 4096 * ok_[:, 6])
            ids_x = np.asarray(ox[:, 5] + 4096 * ox[:, 6])
            pick = float(np.mean(ids_k != ids_x))
            aux = f"id-pick mismatch {pick:.2e}"
        line = (f"  {name:13s} img max abs {img_max:.3e} mean abs "
                f"{img_mean:.3e}, {aux}")
        check(np.isfinite(np.asarray(ok_)).all(), f"{name}: non-finite")
        check(img_max <= IMG_MAX_ABS and img_mean <= IMG_MEAN_ABS,
              f"{name}: image differs from the XLA blender")
        check(pick <= PICK_MISMATCH, f"{name}: id picks differ")
        if differentiable:
            g = jax.random.normal(jax.random.key(5), ox.shape)
            g = g.at[:, 4:].set(0.0)

            def grad(b):
                return jax.jit(jax.grad(lambda a: jnp.sum(rasterize_bins(
                    dataclasses.replace(bins, attrs=a), pix, seed, st,
                    blender=b) * g)))(bins.attrs)
            med, p999 = grad_err(grad(kern), grad(xla))
            line += f", grad rel median {med:.2e} p99.9 {p999:.2e}"
            check(med <= GRAD_MEDIAN_REL and p999 <= GRAD_P999_REL,
                  f"{name}: gradient differs from the XLA blender")
        log(line)

    text = jax.jit(render, static_argnames=("cfg", "max_pairs")).lower(
        prep, cam, cfg).as_text()
    check("__gpu$xla.gpu.triton" in text
          and rasterize_triton.FWD_NAME in text,
          "lowered render() holds no Triton tile-blend kernel call")
    log("  lowered render() calls the Triton kernel "
        f"{rasterize_triton.FWD_NAME}")


def golden_1080p():
    from vk_gaussian_splatting_tpu.config import RenderConfig
    from vk_gaussian_splatting_tpu.scene.cameras import look_at
    from vk_gaussian_splatting_tpu.scene.golden import golden_tiled

    cfg = RenderConfig(width=1920, height=1080, sh_degree=3)
    scene, eye, at = golden_tiled(1_000_000)
    cam = look_at(eye, at, [0, 1, 0], cfg.width, cfg.height, fov_y_rad=0.9)
    return scene, cam, cfg


def phase_full_width(scene, cam, cfg, card):
    import jax
    import jax.numpy as jnp

    from vk_gaussian_splatting_tpu.ops import rasterize_xla
    from vk_gaussian_splatting_tpu.render import render

    prep = jax.jit(lambda s: s.prepare())(scene)
    log(f"  golden-tiled scene: {prep.means.shape[0]} splats, "
        f"{cfg.width}x{cfg.height}")
    wimg = jax.random.normal(jax.random.key(7), (cfg.height, cfg.width, 3))
    dev = jax.devices()[0]
    for kind in ("3dgs", "3dgut", "3dgrt", "3dgs_packed"):
        c = pipeline_cfg(kind, cfg)
        fk = jax.jit(lambda p, cm, c=c: render(p, cm, c)).lower(
            prep, cam).compile()
        fx = jax.jit(lambda p, cm, c=c, k=kind: blended_image(
            k, p, cm, c, rasterize_xla.rasterize_tiles))
        out = fk(prep, cam)
        img_k, img_x = out.image, fx(prep, cam)
        check(np.isfinite(np.asarray(img_k)).all(), f"{kind}: non-finite")
        check(img_k.shape == (cfg.height, cfg.width, 3), f"{kind}: shape")
        img_max, img_mean = image_err(img_k, img_x)
        tk, tx = timed(fk, prep, cam)[0], timed(fx, prep, cam, iters=2)[0]
        log(f"  {kind:12s} kernel vs XLA image max abs {img_max:.3e} mean "
            f"abs {img_mean:.3e}; pairs {int(out.num_pairs)} overflow "
            f"{bool(out.overflow)}; frame ms kernel {tk:.2f} XLA {tx:.2f} "
            f"({card})")
        check(img_max <= IMG_MAX_ABS and img_mean <= IMG_MEAN_ABS,
              f"{kind}: kernel image differs from the XLA blender")
        if kind == "3dgs":
            log(f"  3dgs fwd memory_analysis: {fk.memory_analysis()}")
        if kind in ("3dgs", "3dgut"):
            c0 = c

            def loss_k(p, cm):
                return jnp.sum(render(p, cm, c0).image * wimg)

            def loss_x(p, cm, k=kind):
                return jnp.sum(blended_image(
                    k, p, cm, c0, rasterize_xla.rasterize_tiles) * wimg)
            gk = jax.jit(jax.grad(loss_k)).lower(prep, cam).compile()
            gx = jax.jit(jax.grad(loss_x))
            med, p999 = grad_err(gk(prep, cam), gx(prep, cam))
            tgk = timed(gk, prep, cam)[0]
            tgx = timed(gx, prep, cam, iters=2)[0]
            log(f"  {kind:12s} grad rel error median {med:.2e} p99.9 "
                f"{p999:.2e}; fwd+bwd ms kernel {tgk:.2f} XLA {tgx:.2f} "
                f"({card})")
            check(med <= GRAD_MEDIAN_REL and p999 <= GRAD_P999_REL,
                  f"{kind}: kernel gradient differs from the XLA blender")
            if kind == "3dgs":
                log(f"  3dgs fwd+bwd memory_analysis: "
                    f"{gk.memory_analysis()}")
    stats = dev.memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def phase_train(scene, cam, cfg, card):
    import jax

    from vk_gaussian_splatting_tpu.render import render
    from vk_gaussian_splatting_tpu.train import (
        TrainConfig,
        make_optimizer,
        train_step,
    )

    target = jax.jit(lambda s: render(s.prepare(), cam, cfg).image)(scene)
    start = dataclasses.replace(
        scene, opacities=scene.opacities - 1.0,
        sh_dc=scene.sh_dc + 0.3 * jax.random.normal(
            jax.random.key(11), scene.sh_dc.shape))
    tc = TrainConfig()
    opt = make_optimizer(tc)
    state = opt.init(start)
    splats = start
    losses = []
    for i in range(5):
        t0 = time.perf_counter()
        splats, state, loss, overflow = train_step(
            splats, state, cam, target, cfg, 0, tc, opt)
        losses.append(float(loss))
        log(f"  step {i}: loss {losses[-1]:.6f} overflow {bool(overflow)} "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({card})")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")


def phase_oracle():
    import jax

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_oracle import _oracle_scene, emulate_render, projected_eigen_gaps

    from vk_gaussian_splatting_tpu.config import RenderConfig
    from vk_gaussian_splatting_tpu.ops.projection import project_splats
    from vk_gaussian_splatting_tpu.ops.rasterize_ref import rasterize_naive
    from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs
    from vk_gaussian_splatting_tpu.scene.cameras import look_at

    w, h = 256, 192
    # exact expansion: at this size some splats span more tiles than a slot
    # window holds, and the references have no such cap
    cfg = RenderConfig(width=w, height=h, sh_degree=3)
    cfg = cfg.replace(raster=dataclasses.replace(cfg.raster,
                                                 expansion="exact"))
    splats = _oracle_scene()
    cam = look_at([0.1, -0.2, -4.0], [0, 0, 0], [0, 1, 0], w, h,
                  fov_y_rad=0.9)
    keep = projected_eigen_gaps(splats, cam.viewmat, float(cam.fx),
                                float(cam.fy)) > 1.0
    splats = jax.tree.map(lambda x: x[np.where(keep)[0]], splats)
    prep = splats.prepare()
    out = render_3dgs(prep, cam, cfg, 1 << 16)
    check(not bool(out.overflow), "oracle render overflowed its pair budget")
    img = np.asarray(out.image, np.float64)
    ref_n, _ = rasterize_naive(project_splats(prep, cam, cfg), w, h,
                               cfg.raster)
    ref_e, _ = emulate_render(splats, cam.viewmat, float(cam.fx),
                              float(cam.fy), float(cam.cx), float(cam.cy),
                              w, h, sh_degree=3)
    for name, ref in (("rasterize_naive", ref_n), ("shader emulation", ref_e)):
        mx, mean = image_err(img, ref)
        log(f"  vs {name}: max abs {mx:.3e} mean abs {mean:.3e}")
        check(mx <= ORACLE_MAX_ABS and mean <= ORACLE_MEAN_ABS,
              f"render differs from {name}")


def phase_sharded(card):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vk_gaussian_splatting_tpu.parallel.sharded_render import (
        make_mesh,
        render_3dgs_sharded,
        train_step_sharded,
    )
    from vk_gaussian_splatting_tpu.render import render

    scene, cam, cfg = golden_1080p()
    nd = len(jax.devices())
    mesh = make_mesh(nd)
    n = scene.means.shape[0] // nd * nd
    scene = jax.tree.map(lambda x: x[:n], scene)
    sharded = jax.device_put(scene, NamedSharding(mesh, P("data")))
    check(len(sharded.means.sharding.device_set) == nd,
          "splats are not spread over every card")
    img, trans, overflow = render_3dgs_sharded(sharded, cam, cfg, 0, mesh)
    devs = {s.device for s in img.addressable_shards}
    check(len(devs) == nd, f"image bands landed on {len(devs)} cards")
    log(f"  sharded image bands on cards {sorted(d.id for d in devs)}; "
        f"overflow {bool(overflow)}")
    single = jax.jit(lambda s: render(s.prepare(), cam, cfg).image)(
        jax.device_put(scene, jax.devices()[0]))
    mx, mean = image_err(img, single)
    log(f"  sharded vs one-card render: max abs {mx:.3e} mean abs {mean:.3e}")
    check(mx <= SHARD_MAX_ABS and mean <= IMG_MEAN_ABS,
          "sharded render differs from the one-card render")

    target = jax.device_put(single, NamedSharding(mesh, P("data")))
    start = dataclasses.replace(sharded, opacities=sharded.opacities - 1.0)
    # plain SGD on a sum of squares over the frame: take the largest step
    # size whose four steps all lower the loss
    for lr in (1e-3, 1e-4, 1e-5, 1e-6):
        splats, losses, ms = start, [], []
        for _ in range(4):
            t0 = time.perf_counter()
            splats, loss = train_step_sharded(splats, cam, target, cfg, 0,
                                              mesh, lr=lr)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  sharded SGD lr {lr:g}: losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; step ms "
            f"{', '.join(f'{x:.1f}' for x in ms)} ({card})")
        falling = all(b < a for a, b in zip(losses, losses[1:]))
        if np.isfinite(losses).all() and falling:
            break
    else:
        raise PhaseError("no step size gives a finite, falling sharded loss")
    check(len(splats.means.sharding.device_set) == nd,
          "updated splats left the mesh")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path over four cards")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"chip_smoke: {args.cards} cards asked, {len(devs)} found",
              file=sys.stderr)
        return 2
    cards = smi()
    log(f"device: {devs[0].device_kind} x{len(devs)}, jax {jax.__version__}")
    log(f"nvidia-smi: {cards}")
    card = f"{cards.splitlines()[0]} x{len(devs)}" if cards else "?"

    from vk_gaussian_splatting_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    log(f"compile cache: {enable_compile_cache()}")

    if args.cards == 4:
        phases = [("sharded", lambda: phase_sharded(card))]
    else:
        golden = {}

        def full():
            golden["s"] = golden_1080p()
            phase_full_width(*golden["s"], card)
        phases = [("models", phase_models), ("full width", full),
                  ("training", lambda: phase_train(*golden["s"], card)),
                  ("oracle", phase_oracle)]
    t_all = time.perf_counter()
    for i, (name, fn) in enumerate(phases, start=3):
        t0 = time.perf_counter()
        log(f"phase {i} {name}:")
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — report the phase, then fail
            import traceback
            traceback.print_exc()
            print(f"chip_smoke: phase {name} failed: {e}", file=sys.stderr)
            return 1
        log(f"phase {i} {name}: ok in {time.perf_counter() - t0:.1f} s")
    log(f"all phases: {time.perf_counter() - t_all:.1f} s; {cards}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
