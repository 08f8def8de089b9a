"""Memory statistics (H14, memory_statistics.{h,cpp} + memory_monitor_vk).

Byte accounting per category (Scene / Rasterization / Raytracing) printed in
the reference's BENCHMARK_ADV grammar (gaussian_splatting.cpp:2601-2617), plus
live HBM queries via jax device memory stats (the VK_EXT_memory_budget
analog, memory_monitor_vk.h:29-43).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np


def nbytes_of(tree) -> int:
    return sum(np.asarray(x).nbytes if hasattr(x, "nbytes") else 0
               for x in jax.tree.leaves(tree))


@dataclasses.dataclass
class MemoryCategory:
    host_used: int = 0
    device_used: int = 0
    device_alloc: int = 0


class MemoryStatistics:
    """Per-category byte accounting; benchmarkAdvance printing."""

    def __init__(self):
        self.categories: dict[str, MemoryCategory] = {
            "Scene": MemoryCategory(),
            "Rasterization": MemoryCategory(),
            "Raytracing": MemoryCategory(),
        }

    def set(self, category: str, host_used=0, device_used=0, device_alloc=None):
        c = self.categories.setdefault(category, MemoryCategory())
        c.host_used = int(host_used)
        c.device_used = int(device_used)
        c.device_alloc = int(device_alloc if device_alloc is not None
                             else device_used)

    def account_scene(self, splats, prepared):
        """Host = raw parameter arrays; device = prepared render arrays."""
        self.set("Scene", host_used=nbytes_of(splats),
                 device_used=nbytes_of(prepared))

    def account_raster(self, max_pairs: int, num_tiles: int,
                       n_splats: int):
        """Pair attrs + per-tile segments and outputs (the reference's
        sorting buffers + indirect buffers,
        splat_set_manager_vk.cpp:2426-2517)."""
        from vk_gaussian_splatting_tpu.ops.binning import padded_pairs
        p = padded_pairs(max_pairs)
        attrs = 16 * p * 4
        segments = num_tiles * 2 * 4
        out = num_tiles * 8 * 256 * 4
        proj = n_splats * 15 * 4
        self.set("Rasterization", device_used=attrs + segments + out + proj)

    def account_raytracing(self, device_used: int = 0):
        self.set("Raytracing", device_used=device_used)

    def print_benchmark_adv(self, benchmark_id: int, out=print):
        """BENCHMARK_ADV grammar (gaussian_splatting.cpp:2601-2617)."""
        out(f"BENCHMARK_ADV {benchmark_id} {{")
        for name in ("Scene", "Rasterization", "Raytracing"):
            c = self.categories[name]
            out(f" Memory {name}; Host used \t{c.host_used}; Device Used "
                f"\t{c.device_used}; Device Allocated \t{c.device_alloc}; (bytes)")
        out("}")

    @staticmethod
    def device_memory_summary() -> dict:
        """Live HBM budget (memory_monitor_vk queryVRAMSummary analog)."""
        try:
            stats = jax.devices()[0].memory_stats() or {}
            return {
                "bytes_in_use": stats.get("bytes_in_use", 0),
                "bytes_limit": stats.get("bytes_limit", 0),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use", 0),
            }
        except Exception:
            return {}
