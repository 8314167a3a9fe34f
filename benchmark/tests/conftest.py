"""Shared set-up of the benchmark's own tests (run from the repository's
root: ``python -m pytest benchmark/tests -q``).

Tests that need a CUDA card carry the ``card`` marker and ask for the
``card`` fixture, which skips them where ``torch.cuda.is_available()`` is
false; the look happens inside the fixture, never at import."""

import copy
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# the small sizes of tests/test_torch_vloam.py: a frame in about a second on a CPU
SMALL_SCAN = dict(ring_cap=512, max_points=32768, less_flat_cap=8192)
SMALL_MAP = dict(grid_w=7, grid_h=7, grid_d=3, corner_cube_cap=1024, surf_cube_cap=2048,
                 corner_stack_cap=2048, surf_stack_cap=4096, submap_corner_cap=4096,
                 submap_surf_cap=8192)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda:0")


def small_cell(name="klt.street1", frames=6, judged=3):
    """``name`` at the CPU tests' small sizes: a drive of a few frames
    at 500 azimuths, the configuration's caps cut as the port's tests cut
    them, and the cell's own limits."""
    from vbench import spec
    cell = spec.load_cell(ROOT, name)
    cfg = copy.deepcopy(cell.config)
    cfg["vloam"]["scan"].update(SMALL_SCAN)
    cfg["vloam"]["mapping"].update(SMALL_MAP)
    cfg["vloam"]["verbose_level"] = 0
    tr = copy.deepcopy(cell.traffic)
    tr.update(frames_per_drive=frames, warmup_frames=1, judged_frames=judged, sync_frames=1,
              drift_from_m=2.0)
    tr["lidar"]["n_azimuth"] = 500
    cell.config, cell.traffic = cfg, tr
    return cell


def run_small(cell, seconds=4.0, seed=2**31 + 12345, wrap_driver=None, trace=False):
    from vbench import main
    return main.run(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                    wrap_driver=wrap_driver)
