"""Rolling shutter (S6, projectPointWithShutter — threedgut_camera_
projections.h.slang:189-238 + relativeShutterTime :61-76)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from vk_gaussian_splatting_tpu.config import RenderConfig, ShutterType
from vk_gaussian_splatting_tpu.ops.projection import ut_project_splats
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgut
from vk_gaussian_splatting_tpu.scene.cameras import look_at, make_camera
from vk_gaussian_splatting_tpu.scene.splat_set import random_splats


def _cam_pair(cfg, shift=0.0):
    """Camera plus an end pose translated right by `shift` world units."""
    cam = look_at([0, 0, -8], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height)
    vm_end = np.asarray(cam.viewmat)
    vm_end = vm_end.copy()
    # translate camera +x in world: t = -R @ eye, eye2 = eye + (shift,0,0)
    r = vm_end[:3, :3]
    eye = -r.T @ vm_end[:3, 3]
    vm_end[:3, 3] = -r @ (eye + np.array([shift, 0, 0], np.float32))
    return make_camera(cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy,
                       viewmat_end=vm_end)


def test_static_end_pose_matches_global():
    cfg = RenderConfig(width=64, height=48, sh_degree=0,
                       shutter=ShutterType.ROLLING_TOP_TO_BOTTOM)
    cfg_g = cfg.replace(shutter=ShutterType.GLOBAL)
    splats = random_splats(jax.random.key(0), 200, sh_degree=0).prepare()
    cam = _cam_pair(cfg, shift=0.0)
    p_roll = ut_project_splats(splats, cam, cfg)
    p_glob = ut_project_splats(splats, cam, cfg_g)
    np.testing.assert_allclose(np.asarray(p_roll.xy), np.asarray(p_glob.xy),
                               atol=1e-3)


def test_rolling_shutter_shears_by_row():
    """Camera translating +x during the shutter: bottom-row splats (late
    scan time, top-to-bottom) shift left relative to top-row splats."""
    cfg = RenderConfig(width=64, height=48, sh_degree=0,
                       shutter=ShutterType.ROLLING_TOP_TO_BOTTOM)
    # two identical splats, one high (+y world = low v) one low
    base = random_splats(jax.random.key(1), 2, sh_degree=0)
    means = jnp.array([[0.0, 2.0, 0.0], [0.0, -2.0, 0.0]])
    splats = dataclasses.replace(base, means=means).prepare()
    cam = _cam_pair(cfg, shift=1.0)

    roll = ut_project_splats(splats, cam, cfg)
    glob = ut_project_splats(splats, cam, cfg.replace(
        shutter=ShutterType.GLOBAL))
    xy_r, xy_g = np.asarray(roll.xy), np.asarray(glob.xy)
    # y-down screen: world +y splat is the top row (smaller v)
    assert xy_g[0, 1] < xy_g[1, 1]
    du = xy_r[:, 0] - xy_g[:, 0]
    # this look_at puts camera-right at world -x, so a world +x camera move
    # shifts splats toward +u — and later scan rows shift further
    assert du[1] > du[0] + 1.0, du
    assert du[0] > 0.0, du


def test_rolling_shutter_render_finite():
    cfg = RenderConfig(width=64, height=48, sh_degree=0,
                       shutter=ShutterType.ROLLING_LEFT_TO_RIGHT)
    splats = random_splats(jax.random.key(2), 300, sh_degree=0).prepare()
    cam = _cam_pair(cfg, shift=0.5)
    out = render_3dgut(splats, cam, cfg, max_pairs=1 << 16)
    img = np.asarray(out.image)
    assert np.isfinite(img).all()
    assert img.max() > 0.0
