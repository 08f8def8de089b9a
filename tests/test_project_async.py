"""Project IO roundtrip + async loader + host sorter."""

import time

import jax
import jax.numpy as jnp
import numpy as np

from vk_gaussian_splatting_tpu.config import Pipeline, RenderConfig, ShFormat
from vk_gaussian_splatting_tpu.io import save_ply
from vk_gaussian_splatting_tpu.io.async_loader import (
    AsyncHostSorter,
    AsyncSceneLoader,
    LoadStatus,
)
from vk_gaussian_splatting_tpu.io.project import Project, load_project, save_project
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs
from vk_gaussian_splatting_tpu.scene.cameras import CameraSet, look_at
from vk_gaussian_splatting_tpu.scene.instances import SplatScene
from vk_gaussian_splatting_tpu.scene.lights import LightType, make_light
from vk_gaussian_splatting_tpu.scene.splat_set import random_splats


def test_project_roundtrip(tmp_path):
    splats = random_splats(jax.random.key(0), 100, sh_degree=1)
    ply = tmp_path / "scene.ply"
    save_ply(str(ply), splats)

    scene = SplatScene()
    scene.add_asset(splats, "main")
    m = np.eye(4); m[:3, 3] = [1, 2, 3]
    scene.add_instance(0, transform=m, splat_scale=1.5, name="inst0")

    import dataclasses as dc
    cams = CameraSet()
    cam0 = look_at([0, 0, -5], [0, 0, 0], [0, 1, 0], 320, 240)
    # rolling-shutter end pose + OpenCV distortion must round-trip
    vm_end = np.asarray(cam0.viewmat).copy()
    vm_end[0, 3] += 0.25
    dist = np.zeros(18, np.float32)
    dist[0], dist[6], dist[12] = 0.1, -0.02, 0.3
    cam0 = dc.replace(cam0, viewmat_end=jnp.asarray(vm_end),
                      distortion=jnp.asarray(dist))
    cams.add(cam0, "view0")
    lights = [make_light(LightType.SPOT, position=(1, 1, 1), intensity=2.0,
                         outer_cone_deg=45.0)]
    cfg = RenderConfig(pipeline=Pipeline.MESH_3DGUT, sh_degree=2,
                       sh_format=ShFormat.FLOAT16, width=320, height=240)

    proj = Project(scene=scene, cameras=cams, lights=lights, config=cfg,
                   asset_paths=[str(ply)])
    pp = tmp_path / "session.vkgs.json"
    save_project(str(pp), proj)

    loaded = load_project(str(pp))
    assert loaded.config.pipeline == Pipeline.MESH_3DGUT
    assert loaded.config.sh_format == ShFormat.FLOAT16
    assert loaded.config.sh_degree == 2
    assert len(loaded.scene.assets) == 1
    assert loaded.scene.assets[0].num_splats == 100
    inst = loaded.scene.instances[0]
    np.testing.assert_allclose(inst.transform[:3, 3], [1, 2, 3])
    assert inst.splat_scale == 1.5
    assert len(loaded.cameras.cameras) == 1
    np.testing.assert_allclose(np.asarray(loaded.cameras.get().viewmat),
                               np.asarray(cams.get().viewmat), atol=1e-6)
    np.testing.assert_allclose(np.asarray(loaded.cameras.get().viewmat_end),
                               vm_end, atol=1e-6)
    np.testing.assert_allclose(np.asarray(loaded.cameras.get().distortion),
                               dist, atol=1e-7)
    li = loaded.lights[0]
    assert int(li.type) == int(LightType.SPOT)
    assert float(li.intensity) == 2.0
    # prepared scene renders
    prepared, _ = loaded.scene.flatten(loaded.config.sh_format)
    out = render_3dgs(prepared, loaded.cameras.get(),
                      RenderConfig(width=64, height=48, sh_degree=1), 16384)
    assert np.isfinite(np.asarray(out.image)).all()


def test_async_loader(tmp_path):
    splats = random_splats(jax.random.key(1), 500, sh_degree=1)
    ply = tmp_path / "s.ply"
    save_ply(str(ply), splats)
    loader = AsyncSceneLoader()
    assert loader.load_scene(str(ply))
    for _ in range(200):
        status, _ = loader.get_status()
        if status != LoadStatus.LOADING:
            break
        time.sleep(0.05)
    got = loader.consume()
    assert got is not None and got.num_splats == 500

    # failure surfaces on consume
    loader.load_scene(str(tmp_path / "missing.ply"))
    for _ in range(100):
        if loader.get_status()[0] != LoadStatus.LOADING:
            break
        time.sleep(0.05)
    try:
        loader.consume()
        assert False, "expected exception"
    except FileNotFoundError:
        pass


def test_host_sorter_and_render_parity():
    cfg = RenderConfig(width=64, height=48, sh_degree=0)
    splats = random_splats(jax.random.key(2), 200, sh_degree=0,
                           scale_range=(-2.5, -1.2))
    prepared = splats.prepare()
    cam = look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height)

    sorter = AsyncHostSorter(np.asarray(prepared.means))
    view_dir = np.asarray(cam.viewmat)[2, :3]  # camera forward row
    sorter.sort_async(view_dir)
    for _ in range(100):
        res = sorter.consume()
        if res is not None:
            break
        time.sleep(0.02)
    order, _ = res

    out_host = render_3dgs(prepared, cam, cfg, 16384,
                           host_order=jnp.asarray(order))
    out_dev = render_3dgs(prepared, cam, cfg, 16384)
    # fresh host order == device depth order (same camera)
    np.testing.assert_allclose(np.asarray(out_host.image),
                               np.asarray(out_dev.image), atol=1e-5)


def test_project_roundtrips_new_config_fields(tmp_path):
    import dataclasses as _dc

    from vk_gaussian_splatting_tpu.config import ShutterType
    from vk_gaussian_splatting_tpu.io.project import (
        Project,
        load_project,
        save_project,
    )
    from vk_gaussian_splatting_tpu.scene.cameras import CameraSet

    cfg = RenderConfig(shutter=ShutterType.ROLLING_LEFT_TO_RIGHT)
    cfg = cfg.replace(raster=_dc.replace(cfg.raster, pair_format="packed"),
                      rt=_dc.replace(cfg.rt, max_bounces=5))
    from vk_gaussian_splatting_tpu.scene.instances import SplatScene

    proj = Project(scene=SplatScene(), cameras=CameraSet(), lights=[],
                   config=cfg, asset_paths=[])
    path = str(tmp_path / "p.vkgs.json")
    save_project(path, proj)
    back = load_project(path)
    assert back.config.shutter == ShutterType.ROLLING_LEFT_TO_RIGHT
    assert back.config.raster.pair_format == "packed"
    assert back.config.rt.max_bounces == 5


