"""``benches/warp_cycles.py`` finds the tile loop of every pipelined kernel.

The instrumented copies are built and run only on the card; what this
checks, on the CPU, is the source rewrite: each of the port's tile-pipeline
sources (K1, K2's plans, K4, K5, K6, K7) gets one timed tile loop, the per-warp
write right after it and the read-back entry point after its includes, and a
source without such a loop is left to be built as it is and timed only.
"""
import re

import pytest

from rodio_tpu_torch.benches import warp_cycles
from rodio_tpu_torch.ops import _build


@pytest.mark.parametrize("name", warp_cycles.SOURCES)
def test_instrument_times_each_tile_loop(name):
    src = (_build.CSRC / name).read_text()
    tag = name[:-3]
    out = warp_cycles.instrument(src, tag)
    assert out is not None, name
    assert out.count("const long long t0_ = clock64();") == 1
    assert out.count("busy_ += clock64() - t0_;") == 1
    assert out.count(f'extern "C" int rt_warp_cycles_{tag}(long long* out)') == 1
    assert out.count(f'extern "C" int rt_block_cycles_{tag}(long long* out)') == 1
    assert out.count(f'extern "C" int rt_block_cycles_clear_{tag}()') == 1
    # the timer wraps the loop body, the per-warp write follows the loop, and
    # the entry point sits after the last include
    loop = out.index("for (int it = 0;")
    assert out.index("const long long start_") < loop < out.index("t0_ = clock64()")
    end = out.index("busy_ += clock64() - t0_;")
    assert end < out.index("g_warp_cycles[threadIdx.x >> 5] = busy_;")
    last_include = max(m.end() for m in re.finditer(r'#include "[^"]+"\n', out))
    assert out.index("static __device__ long long g_warp_cycles") >= last_include
    # nothing else changes: the source's lines, in order, and 27 more (the
    # timer's 4, the writes' 8, the entry points' 15)
    lines, rest = src.splitlines(), iter(out.splitlines())
    assert all(any(line == o for o in rest) for line in lines)
    assert len(out.splitlines()) == len(lines) + 27


def test_instrument_leaves_a_source_without_a_tile_loop():
    # a per-lane loop without the pipeline's barrier-ended tile loop (as
    # K4's was before it ran on chain_pipeline.cuh) is timed only
    src = ('#include "precise_math.cuh"\n__global__ void k(float* y, int n) {\n'
           "  for (int i = 0; i < n; ++i) y[i] = 0.f;\n}\n")
    assert warp_cycles.instrument(src, "k") is None


def test_instrument_phases_times_each_marked_phase():
    # K8 marks its phases with RT_PHASE(k); the rewrite defines the mark to
    # read clock64() into an array of one slot per mark and adds its read-back
    src = (_build.CSRC / "bma.cu").read_text()
    marks = sorted(int(k) for k in re.findall(r"RT_PHASE\((\d+)\);", src))
    assert marks == list(range(len(warp_cycles.PHASES) + 1))
    out = warp_cycles.instrument_phases(src, "bma")
    assert out.index("#define RT_PHASE(k)") < out.index("#ifndef RT_PHASE")
    assert f"g_phase_cycles[{len(marks)}];" in out
    assert out.count('extern "C" int rt_phase_cycles_bma(long long* out)') == 1
    assert src in out
    # a source without marks (an earlier K8) is timed only
    assert warp_cycles.instrument_phases(src.replace("RT_PHASE(", "PHASE("), "bma") is None


def test_kernel_sources_cover_every_kernel():
    """``--kernels`` builds the sources KERNEL_SOURCES names: each is one
    the library builds, instrumented or timed."""
    assert set(warp_cycles.KERNEL_SOURCES.values()) <= set(warp_cycles.SOURCES
                                                          + warp_cycles.TIMED)
    for name in warp_cycles.KERNEL_SOURCES.values():
        assert (_build.CSRC / name).exists(), name
    assert {"K1", "K2", "K2r", "K2b", "K2g", "K3", "K4", "K5", "K6", "K7", "K8", "K9",
            "stream_max"} == set(warp_cycles.KERNEL_SOURCES)


def test_k9_version_is_read_from_its_source():
    """K9's TMA ring takes lanes and a route; a version before it (32 lanes,
    cp.async only) is bound with its own arguments."""
    assert not warp_cycles.k9_before_tma((_build.CSRC / "dma_roofline.cu").read_text())
    assert warp_cycles.k9_before_tma(
        'extern "C" int rt_dma_ring(const float* x, long long R, int L, int tr,\n'
        "                           int depth, float* out, void* stream) {")
