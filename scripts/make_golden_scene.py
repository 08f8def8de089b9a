"""Generate the trained-statistics golden corpus (VERDICT r03 next #5).

Every render in rounds 1-3 used raw `random_splats`; trained scenes have
radically different screen statistics (the r02->r03 bench-cap fiasco was
exactly this bite). This script produces a CHECKED-IN trained scene:

1. teacher: a procedural structured scene (floor + sphere + colored boxes,
   dense tiny splats) — renderable ground truth, NOT the corpus itself;
2. render the teacher from K orbit cameras -> target images;
3. student: random init, optimized with train.train_step (Adam per-field,
   L1+SSIM) with densify-split + prune rounds until it converges on the
   targets — the optimization is what imprints trained statistics
   (size/opacity distributions adapting to screen-space detail, INRIA-style
   benchmark.py:419-433);
4. save: assets/golden/golden_scene.ply (our io.ply writer), meta.json
   (recipe, per-view PSNR, screen-radius profile), golden_view.npy golden
   render, and orbit PNGs for the docs.

Run on the GPU (pass --cpu to force the CPU, which is much slower):
    python scripts/make_golden_scene.py
"""

import json
import os
import sys
import time

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from vk_gaussian_splatting_tpu.config import RenderConfig  # noqa: E402
from vk_gaussian_splatting_tpu.io.ply import save_ply  # noqa: E402
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs  # noqa: E402
from vk_gaussian_splatting_tpu.scene.cameras import look_at  # noqa: E402
from vk_gaussian_splatting_tpu.scene.splat_set import SplatSet  # noqa: E402
from vk_gaussian_splatting_tpu.train import (  # noqa: E402
    TrainConfig,
    densify_split,
    make_optimizer,
    prune_splats,
    train_step,
)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "assets", "golden")
W, H = 256, 192
N_VIEWS = 16
STEPS_PER_ROUND = 250
DENSIFY_ROUNDS = 3
SEED = 7


def teacher_scene() -> SplatSet:
    """Structured procedural teacher: floor plane + sphere + two boxes with
    distinct colors, as ~40k small splats (surface sampling)."""
    rng = np.random.default_rng(SEED)

    def surf(n, pts, color, scale=-4.6):
        return dict(means=pts,
                    scales=np.full((n, 3), scale) + rng.normal(0, 0.15, (n, 3)),
                    quats=rng.normal(size=(n, 4)),
                    opacities=rng.uniform(1.5, 3.5, n),
                    sh_dc=np.tile(color, (n, 1)) + rng.normal(0, 0.05, (n, 3)))

    parts = []
    # floor y = +1.5 (y down), checker color
    n = 16000
    xz = rng.uniform(-3, 3, (n, 2))
    pts = np.stack([xz[:, 0], np.full(n, 1.5), xz[:, 1]], -1)
    checker = ((np.floor(xz[:, 0]) + np.floor(xz[:, 1])) % 2)[:, None]
    col = np.where(checker > 0, [0.9, 0.85, 0.7], [0.25, 0.3, 0.35])
    d = surf(n, pts, [0, 0, 0])
    d["sh_dc"] = col + rng.normal(0, 0.03, (n, 3))
    parts.append(d)
    # sphere r=1 at origin
    n = 12000
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v * 1.0 + [0, 0.5, 0]
    col = 0.5 + 0.5 * v  # normal-colored
    parts.append(surf(n, pts, [0, 0, 0]) | {"sh_dc": col})
    # two boxes
    for c, ctr in ([[0.9, 0.2, 0.15], [-1.8, 1.0, 1.0]],
                   [[0.15, 0.3, 0.9], [1.8, 0.9, -0.8]]):
        n = 6000
        face = rng.integers(0, 3, n)
        sgn = rng.choice([-0.5, 0.5], n)
        p = rng.uniform(-0.5, 0.5, (n, 3))
        p[np.arange(n), face] = sgn
        parts.append(surf(n, p + np.asarray(ctr), c))
    fields = {}
    for k in parts[0]:
        fields[k] = jnp.asarray(np.concatenate([p[k] for p in parts]),
                                jnp.float32)
    n_total = fields["means"].shape[0]
    return SplatSet(**fields, sh_rest=jnp.zeros((n_total, 0, 3), jnp.float32))


def orbit_cams(cfg, n=N_VIEWS, r=7.0, y=-1.5):
    cams = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = [r * np.sin(a), y, -r * np.cos(a)]
        cams.append(look_at(eye, [0, 0.5, 0], [0, 1, 0], cfg.width,
                            cfg.height, fov_y_rad=0.9))
    return cams


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def main():
    t0 = time.time()
    os.makedirs(OUT_DIR, exist_ok=True)
    cfg = RenderConfig(width=W, height=H, sh_degree=0)
    teacher = teacher_scene().prepare()
    cams = orbit_cams(cfg)
    targets = [jnp.clip(render_3dgs(teacher, c, cfg, max_pairs=1 << 21).image,
                        0, 1) for c in cams]
    jax.block_until_ready(targets)
    print(f"[{time.time()-t0:.0f}s] teacher rendered", flush=True)

    # student init: subsampled teacher positions + noise, coarse scales
    rng = np.random.default_rng(SEED + 1)
    n0 = 8000
    t_means = np.asarray(teacher.means)
    idx = rng.choice(t_means.shape[0], n0, replace=False)
    student = SplatSet(
        means=jnp.asarray(t_means[idx] + rng.normal(0, 0.05, (n0, 3)),
                          jnp.float32),
        scales=jnp.full((n0, 3), -3.0) + 0.1 * jnp.asarray(
            rng.normal(size=(n0, 3)), jnp.float32),
        quats=jnp.asarray(rng.normal(size=(n0, 4)), jnp.float32),
        opacities=jnp.zeros((n0,), jnp.float32),
        sh_dc=jnp.asarray(rng.uniform(0, 0.5, (n0, 3)), jnp.float32),
        sh_rest=jnp.zeros((n0, 0, 3), jnp.float32),
    )

    tc = TrainConfig(scene_extent=4.0)
    for rnd in range(DENSIFY_ROUNDS + 1):
        opt = make_optimizer(tc)
        state = opt.init(student)
        for s in range(STEPS_PER_ROUND):
            v = (s + rnd) % N_VIEWS
            student, state, loss, ov = train_step(
                student, state, cams[v], targets[v], cfg, 1 << 21, tc,
                optimizer=opt)
            if s % 100 == 0:
                print(f"[{time.time()-t0:.0f}s] round {rnd} step {s} "
                      f"loss {float(loss):.4f} overflow {bool(ov)}",
                      flush=True)
        if rnd < DENSIFY_ROUNDS:
            # densify from view-0 gradient magnitude, then prune
            def loss_fn(st_):
                img = render_3dgs(st_.prepare(), cams[0], cfg,
                                  max_pairs=1 << 21).image
                return jnp.mean(jnp.abs(img - targets[0]))
            g = jax.grad(loss_fn)(student)
            student = densify_split(student, g.means, grad_threshold=2e-6)
            student = prune_splats(student)
            print(f"[{time.time()-t0:.0f}s] densified -> "
                  f"{student.means.shape[0]} splats", flush=True)

    # evaluate + screen-radius profile
    from vk_gaussian_splatting_tpu.ops.projection import project_splats

    prepared = student.prepare()
    psnrs = [psnr(jnp.clip(render_3dgs(prepared, c, cfg,
                                       max_pairs=1 << 21).image, 0, 1), t)
             for c, t in zip(cams, targets)]
    radii = np.asarray(jax.jit(
        lambda p, c: project_splats(p, c, cfg).radius.max(axis=1))(
            prepared, cams[0]))
    vis = radii > 0
    stats = {
        "n_splats": int(student.means.shape[0]),
        "psnr_per_view": [round(p, 2) for p in psnrs],
        "psnr_mean": round(float(np.mean(psnrs)), 2),
        "screen_radius_median": round(float(np.median(radii[vis])), 2),
        "screen_radius_p99": round(float(np.quantile(radii[vis], 0.99)), 2),
        "frac_fine": round(float((radii[vis] < 8).mean()), 4),
        "recipe": {"seed": SEED, "views": N_VIEWS, "res": [W, H],
                   "steps_per_round": STEPS_PER_ROUND,
                   "densify_rounds": DENSIFY_ROUNDS},
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(stats, indent=1), flush=True)

    save_ply(os.path.join(OUT_DIR, "golden_scene.ply"), student)
    with open(os.path.join(OUT_DIR, "meta.json"), "w") as f:
        json.dump(stats, f, indent=1)
    img0 = np.asarray(jnp.clip(render_3dgs(prepared, cams[0], cfg,
                                           max_pairs=1 << 21).image, 0, 1))
    np.save(os.path.join(OUT_DIR, "golden_view0.npy"),
            img0.astype(np.float16))
    try:
        from PIL import Image
        for i in (0, 4, 8, 12):
            im = np.asarray(jnp.clip(render_3dgs(
                prepared, cams[i], cfg, max_pairs=1 << 21).image, 0, 1))
            Image.fromarray((im * 255).astype(np.uint8)).save(
                os.path.join(OUT_DIR, f"orbit_{i:02d}.png"))
        tgt = np.asarray(targets[0])
        Image.fromarray((tgt * 255).astype(np.uint8)).save(
            os.path.join(OUT_DIR, "teacher_view0.png"))
    except ImportError:
        pass
    print(f"[{time.time()-t0:.0f}s] golden corpus written to {OUT_DIR}",
          flush=True)


if __name__ == "__main__":
    main()
