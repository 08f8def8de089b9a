"""Benchmark sequencer: replays the reference's SEQUENCE cfg files.

Speaks the exact grammar of the reference toolchain so its ``benchmark.py``
parser works on our stdout (SURVEY.md §3.5):

- cfg files: ``SEQUENCE "name"`` blocks of ``--param value`` lines
  (nvutils::ParameterSequencer, main.cpp:39-44; e.g. benchmark_3dgs.cfg)
- per block: apply params, render ``sequenceframes`` frames, print
  ``ParameterSequence {id} "{name}" =``, per-stage ``Timer`` lines
  (utils/profiling.py) and the ``BENCHMARK_ADV`` memory block
  (utils/memstats.py).

Recognized params (parameters.cpp:90-142 + UI registrations
gaussian_splatting_ui.cpp:63-83): pipeline, shformat, maxShDegree,
kernelDegree, sequenceframes/averages/resetframes, updateData, screenshot,
benchmark. Vulkan-only acceleration-structure switches (useAABBs,
useTlasInstances, compressBlas, extentProjection) are accepted and ignored —
there is no BLAS/TLAS here (noted to stdout once).
"""

from __future__ import annotations

import dataclasses
import re
import shlex
import time

import jax
import numpy as np

from vk_gaussian_splatting_tpu.config import Pipeline, RenderConfig, ShFormat, tiles_x, tiles_y
from vk_gaussian_splatting_tpu.ops.projection import project_splats, ut_project_splats
from vk_gaussian_splatting_tpu.render.pipelines import render
from vk_gaussian_splatting_tpu.utils.memstats import MemoryStatistics
from vk_gaussian_splatting_tpu.utils.profiling import FrameTimers


def parse_sequence_file(path: str) -> list[tuple[str, dict]]:
    """cfg -> [(name, {param: value})]."""
    blocks: list[tuple[str, dict]] = []
    current: dict | None = None
    name = ""
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r'SEQUENCE\s+"([^"]*)"', line)
            if m:
                if current is not None:
                    blocks.append((name, current))
                name = m.group(1)
                current = {}
                continue
            if current is None:
                continue
            toks = shlex.split(line)
            i = 0
            while i < len(toks):
                if toks[i].startswith("--"):
                    key = toks[i][2:]
                    if i + 1 < len(toks) and not toks[i + 1].startswith("--"):
                        current[key] = toks[i + 1]
                        i += 2
                    else:
                        current[key] = ""
                        i += 1
                else:
                    i += 1
    if current is not None:
        blocks.append((name, current))
    return blocks


_IGNORED = {"useAABBs", "useTlasInstances", "compressBlas", "extentProjection",
            "vsync", "benchmark"}


class BenchmarkSequencer:
    """Executes SEQUENCE blocks against the render pipelines."""

    def __init__(self, splats, width: int, height: int, camera, out=print,
                 max_pairs: int | None = None):
        self.splats = splats
        self.camera = camera
        self.out = out
        self.cfg = RenderConfig(width=width, height=height)
        self.max_pairs = max_pairs or max(4 * splats.num_splats, 1 << 20)
        self.frames = 128
        self.averages = 128
        self.reset_frames = 0
        self.prepared = None
        self.benchmark_id = 0
        self.memstats = MemoryStatistics()
        self._warned_ignored = False

    # -- parameter application (the sequencer's CLI re-parse) -----------
    def apply(self, params: dict):
        cfg = self.cfg
        for key, val in params.items():
            if key == "pipeline":
                cfg = cfg.replace(pipeline=Pipeline(int(val)))
            elif key == "shformat":
                cfg = cfg.replace(sh_format=ShFormat(int(val)))
            elif key == "maxShDegree":
                cfg = cfg.replace(sh_degree=int(val))
            elif key == "kernelDegree":
                cfg = cfg.replace(rt=dataclasses.replace(
                    cfg.rt, kernel_degree=int(val)))
            elif key == "sequenceframes":
                self.frames = int(val)
            elif key == "sequenceaverages":
                self.averages = int(val)
            elif key == "sequenceresetframes":
                self.reset_frames = int(val)
            elif key in ("updateData", "screenshot"):
                pass  # handled by run_block
            elif key in _IGNORED:
                if not self._warned_ignored:
                    self.out(f"note: ignoring Vulkan-only parameter --{key} "
                             "(no acceleration structures here)")
                    self._warned_ignored = True
            else:
                self.out(f"note: unknown parameter --{key} ignored")
        self.cfg = cfg

    def update_data(self):
        """The --updateData trigger: re-prepare splats for the current
        sh format (SplatSetVk::initDataStorage re-run)."""
        self.prepared = self.splats.prepare(self.cfg.sh_format)
        self.memstats.account_scene(self.splats, self.prepared)

    def screenshot(self, path: str):
        import os
        out = render(self.prepared if self.prepared is not None
                     else self.splats.prepare(self.cfg.sh_format),
                     self.camera, self.cfg, self.max_pairs)
        img = np.clip(np.asarray(out.image), 0, 1)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        try:
            from PIL import Image
            Image.fromarray((img * 255).astype(np.uint8)).save(path)
        except ImportError:
            np.save(path + ".npy", img)
        self.out(f'Screenshot saved to "{path}"')

    # -- measured run ----------------------------------------------------
    def run_block(self, idx: int, name: str, params: dict):
        self.out(f'ParameterSequence {idx} "{name}" =')
        self.apply(params)
        if "updateData" in params:
            self.update_data()
            self._measure()
        if "screenshot" in params and params["screenshot"]:
            self.screenshot(params["screenshot"])
        self.memstats.print_benchmark_adv(self.benchmark_id, self.out)
        self.benchmark_id += 1

    def _stage_fns(self):
        cfg = self.cfg
        max_pairs = self.max_pairs
        gut = cfg.pipeline in (Pipeline.RTX, Pipeline.MESH_3DGUT,
                               Pipeline.HYBRID_3DGUT)
        packed = cfg.raster.pair_format == "packed"
        proj_fn = ut_project_splats if gut else project_splats

        @jax.jit
        def dist(prepared, cam):
            return proj_fn(prepared, cam, cfg)

        # the sort stage uses the PIPELINE'S real attribute rows — the gut3d
        # layouts carry 11/16 payloads vs gs2d's 8/11, and the sort stage is
        # payload-bound, so timing the gs rows for pipelines 2/4/5 would
        # misreport exactly the tables the reference benchmarks
        def rows_fn(prepared, proj):
            from vk_gaussian_splatting_tpu.render.pipelines import (
                gs_attr_rows,
                gs_attr_rows_packed,
                gut_attr_rows,
                gut_attr_rows_packed,
            )
            if gut:
                return (gut_attr_rows_packed if packed
                        else gut_attr_rows)(prepared, proj, cfg)
            return (gs_attr_rows_packed if packed else gs_attr_rows)(proj)

        def sort(prepared, proj):
            from vk_gaussian_splatting_tpu.render.pipelines import bin_for_cfg
            return bin_for_cfg(proj, rows_fn(prepared, proj), cfg,
                               max_pairs).pair_splat

        def frame(prepared, cam):
            return render(prepared, cam, cfg, max_pairs)

        return dist, sort, frame

    def _measure(self):
        from vk_gaussian_splatting_tpu.config import SortMethod
        timers = FrameTimers()
        dist, sort, frame = self._stage_fns()
        prepared, cam = self.prepared, self.camera
        host_sort = self.cfg.raster.sort_method == SortMethod.HOST

        # warmup / reset frames (compile)
        for _ in range(max(self.reset_frames, 1)):
            jax.block_until_ready(frame(prepared, cam).image)
        proj = jax.block_until_ready(dist(prepared, cam))
        jax.block_until_ready(sort(prepared, proj))

        n = max(min(self.frames, 1024) // max(self.averages, 1), 1)
        stage_name = ("Raytracing" if self.cfg.pipeline in
                      (Pipeline.RTX, Pipeline.HYBRID, Pipeline.HYBRID_3DGUT)
                      else "Rasterization")
        for _ in range(n):
            with timers.section("GPU Dist"):
                proj = jax.block_until_ready(dist(prepared, cam))
            if host_sort:
                # the async CPU sorting path (SplatSorterAsync,
                # splat_sorter_async.cpp:92-138): plane distances + argsort
                # on the host, permutation shipped to device
                with timers.section("CPU Dist"):
                    depth_h = np.asarray(proj.depth)
                with timers.section("CPU Sort"):
                    order = np.argsort(depth_h, kind="stable")
                del order
            with timers.section("GPU Sort"):
                jax.block_until_ready(sort(prepared, proj))
            with timers.section(stage_name):
                jax.block_until_ready(frame(prepared, cam).image)
        # the full-frame fused time is the "Rasterization"/"Raytracing" time;
        # subtract? no — stages are measured independently; also report Frame
        t0 = time.perf_counter()
        reps = max(n, 3)
        for _ in range(reps):
            o = frame(prepared, cam)
        jax.block_until_ready(o.image)
        timers.add("Frame", (time.perf_counter() - t0) / reps)
        self.memstats.account_raster(
            self.max_pairs, tiles_x(self.cfg) * tiles_y(self.cfg),
            self.prepared.num_splats)
        if self.cfg.pipeline in (Pipeline.RTX, Pipeline.HYBRID,
                                 Pipeline.HYBRID_3DGUT):
            self.memstats.account_raytracing(
                self.memstats.categories["Rasterization"].device_used)
        timers.print_timers(self.out)

    def run(self, blocks: list[tuple[str, dict]]):
        for idx, (name, params) in enumerate(blocks):
            self.run_block(idx, name, params)
