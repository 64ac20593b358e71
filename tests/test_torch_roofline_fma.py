"""R2's launch geometry (csrc/roofline.cu, ``mr_roofline_fma_shape``),
mirrored by ``meshrecon_torch.tools.roofline.fma_shape``, on the CPU.

The kernel runs ``FMA_CHAINS`` elements a thread, thread t of the grid
taking elements t + c * (CTAs x threads) below n, on a grid sized from the
SM count. Here the mirror's map must cover every element exactly once,
for the roofline tool's (256, 512) block, the card tests' (5, 77), prime
counts, and SM counts other than the H100's 132; the card test
(``tests/test_torch_kernels_cuda.py``) holds the C function to the mirror.
"""

import numpy as np
import pytest

from meshrecon_torch.tools import roofline

SIZES = [256 * 512, 5 * 77, 7919, 1_000_003]
SMS = [132, 114, 1]


def _elements(n, sms):
    """Every (thread, chain)'s element under the kernel's map, -1 where it
    lies past n (the chain runs, its result is not stored)."""
    blocks, threads, chains = roofline.fma_shape(n, sms)
    stride = blocks * threads
    e = (np.arange(stride)[:, None] + stride * np.arange(chains)[None, :])
    return np.where(e < n, e, -1), blocks, threads


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n", SIZES)
def test_map_covers_every_element_once(n, sms):
    e, blocks, threads = _elements(n, sms)
    stored = np.sort(e[e >= 0])
    np.testing.assert_array_equal(stored, np.arange(n))
    assert threads % 32 == 0 and 32 <= threads <= roofline.FMA_MAX_THREADS
    # no CTA is empty: the last one holds at least one element
    assert (e[(blocks - 1) * threads:] >= 0).any()


@pytest.mark.parametrize("sms", [132, 114])
def test_tool_block_fills_each_sm_once(sms):
    """At the tool's 256x512 a CTA takes one SM's share in whole warps: no
    more CTAs than SMs, and the grid holds n elements where one CTA fewer
    would not."""
    n = 256 * 512
    blocks, threads, chains = roofline.fma_shape(n, sms)
    assert blocks <= sms
    assert (blocks - 1) * threads * chains < n <= blocks * threads * chains


def test_h100_geometry():
    """The tool's block on the H100's 132 SMs: 128 CTAs of 256 threads,
    four chains each, which cover the 131,072 elements exactly; two warps
    of four chains, 8 warp-chains, on each of an SM's 4 sub-partitions, the
    least that 4,096 warp-chains (131,072 / 32) allow on 528 of them."""
    n = 256 * 512
    blocks, threads, chains = roofline.fma_shape(n, 132)
    assert (blocks, threads, chains) == (128, 256, 4)
    assert blocks * threads * chains == n
    assert threads // 32 // 4 * chains == -(-(n // 32) // (4 * 132)) == 8
    assert roofline.fma_shape(5 * 77, 132) == (4, 32, 4)


@pytest.mark.parametrize("n,sms", [(0, 132), (10, 0), (-1, 4)])
def test_shape_refuses(n, sms):
    with pytest.raises(ValueError):
        roofline.fma_shape(n, sms)


def test_kernel_variants_needs_the_card(monkeypatch):
    """The variants tool (R2's and K3b's rejected designs against the kept
    kernels) raises without CUDA rather than timing anything on the host,
    and its source declares the two entries it binds."""
    from meshrecon_torch.tools import kernel_variants

    monkeypatch.setattr(kernel_variants.torch.cuda, "is_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_variants.main([])
    src = kernel_variants.SOURCE.read_text()
    assert "MR_EXPORT int mr_variant_k3b(" in src
    assert "MR_EXPORT int mr_variant_r2(" in src


def test_kernel_variants_refuses_unknown_kernels():
    """--kernels takes the tool's sections only (k3b, r2, setup, bin,
    bin_split), and says so before it looks for the card; the variants'
    source declares the binning entries it binds."""
    from meshrecon_torch.tools import kernel_variants

    with pytest.raises(SystemExit):
        kernel_variants.main(["--kernels", "setup,sort"])
    assert kernel_variants.KERNELS == ("k3b", "r2", "setup", "bin",
                                       "bin_split")
    src = kernel_variants.SOURCE.read_text()
    for entry in ("mr_variant_setup", "mr_variant_bin",
                  "mr_variant_bin_timed"):
        assert f"MR_EXPORT int {entry}(" in src
    assert '#include "raster_setup.cu"' in src
