"""What the host computes for the tensor-core forward kernel (K1 / K3 / K7
on bf16 / fp16): K7's TMA boxes over a page pool, the pool view its map
reads, and the 16-byte checks that refuse a tensor TMA cannot take before
any launch.  All run on the CPU: the checks come before the kernel
library is loaded.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import decode_attention as da
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

# every page size the serving engine admits: multiples of 8 (it rounds
# page_size up to one), here up to 512
PAGES = list(range(8, 513, 8))


@pytest.mark.parametrize("page", PAGES)
def test_box_rows_tile_a_key_tile_within_pages(page):
    """Box rows divide the 64-row key tile and the page and are a multiple
    of 8 (each box starts on the 128-byte swizzle's 1024-byte period);
    the boxes of every key tile cover it once, each inside one page."""
    r = pa.paged_box_rows(page)
    assert r % 8 == 0 and pa.KEY_TILE % r == 0 and page % r == 0
    n = pa.KEY_TILE // r
    for k0 in range(0, 4 * max(page, pa.KEY_TILE), pa.KEY_TILE):
        rows = []
        for j in range(n):
            v = k0 + j * r
            assert v % page + r <= page           # never crosses a page
            assert (j * r * 128) % 1024 == 0      # its byte offset in the tile
            rows.extend(range(v, v + r))
        assert rows == list(range(k0, k0 + pa.KEY_TILE))


@pytest.mark.parametrize("page", [0, -8, 4, 12, 100])
def test_box_rows_refuse_pages_off_the_8_grid(page):
    with pytest.raises(ValueError, match="multiple of 8"):
        pa.paged_box_rows(page)


@pytest.mark.parametrize("page", [8, 24, 64])
@pytest.mark.parametrize("D", [64, 128])
def test_pool_tma_view_reads_the_gathered_rows(page, D):
    """Box j of a key tile reads the pool view at (pages[b, v // page],
    v % page, kv head) for virtual row v: the rows of the gathered view."""
    rng = np.random.default_rng(page + D)
    KVH, n_virt, B = 2, 5, 3
    n_pages = 1 + B * n_virt
    pool = torch.from_numpy(rng.standard_normal(
        (n_pages, page, KVH * D)).astype(np.float32)).to(torch.bfloat16)
    pages = torch.from_numpy(1 + rng.permutation(n_pages - 1)
                             .reshape(B, n_virt).astype(np.int32))
    view = pa.pool_tma_view(pool, D)
    assert view.shape == (n_pages, page, KVH, D)
    assert view.data_ptr() == pool.data_ptr()
    es = pool.element_size()
    assert [s * es for s in view.stride()] == [page * KVH * D * es,
                                               KVH * D * es, D * es, es]
    gathered = pa.gather_pages(pool, pages).view(B, n_virt * page, KVH, D)
    r = pa.paged_box_rows(page)
    for b in range(B):
        for v in range(0, n_virt * page, r):
            box = view[int(pages[b, v // page]), v % page:v % page + r]
            assert torch.equal(box, gathered[b, v:v + r])


def _bf16(*shape, offset=0, strides=None):
    """A bf16 CPU tensor of ``shape`` over fresh storage, at ``offset``
    elements and with ``strides`` (default: contiguous)."""
    base = torch.zeros(int(np.prod(shape)) * 2 + 64, dtype=torch.bfloat16)
    strides = strides or torch.empty(shape).stride()
    return base.as_strided(shape, strides, offset)


def test_check_tma_takes_16_byte_addresses_and_strides():
    B, S, H, D = 2, 8, 4, 64
    good = _bf16(B, S, H, D)
    assert good.data_ptr() % 16 == 0
    fa.check_tma("k1", "q", good)                      # no error
    fa.check_tma("k1", "q", _bf16(B, S, H, D, offset=8))   # 16 bytes on
    with pytest.raises(ValueError, match="TMA"):
        fa.check_tma("k1", "q", _bf16(B, S, H, D, offset=1))
    # h stride 68 elements = 136 bytes
    odd = _bf16(B, S, H, D, strides=(S * H * 68, H * 68, 68, 1))
    with pytest.raises(ValueError, match="TMA"):
        fa.check_tma("k1", "k", odd)
    # s stride 4 * 64 + 4 elements = 520 bytes
    with pytest.raises(ValueError, match="TMA"):
        fa.check_tma("k1", "v", _bf16(B, S, H, D,
                                      strides=(S * 260, 260, 64, 1)))


def test_16bit_forward_wrappers_refuse_before_launch():
    """K1, K3, K3-int8 and K7 check TMA's rules on their 16-bit operands
    before the kernel library is loaded (here: no nvcc, no card)."""
    B, S, H, D = 1, 16, 2, 64
    ok = _bf16(B, S, H, D)
    shifted = _bf16(B, S, H, D, offset=1)
    with pytest.raises(ValueError, match="TMA"):
        fa.launch_attention_kernel(shifted, ok, ok, True, 0.1, None, True)
    with pytest.raises(ValueError, match="TMA"):
        fa.launch_attention_kernel(ok, ok, shifted, False, 0.1, None, False)
    with pytest.raises(ValueError, match="no keys"):
        fa.launch_attention_kernel(ok, _bf16(B, 0, H, D), _bf16(B, 0, H, D),
                                   True, 0.1, None, False)
    starts = torch.zeros(B, dtype=torch.int32)
    kc = torch.zeros(B, 32, H * D, dtype=torch.int8)
    sc = torch.ones(B, 32, H)
    with pytest.raises(ValueError, match="TMA"):
        da._launch_chunk_int8(shifted, kc, kc, sc, sc, starts, 0.1)
    pool = torch.zeros(3, 24, H * D, dtype=torch.bfloat16)
    pages = torch.tensor([[1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="TMA"):
        pa._launch_paged_chunk(shifted, pool, pool, None, None, starts,
                               pages, 0.1)
    with pytest.raises(ValueError, match="multiple of 8"):
        pa._launch_paged_chunk(ok, torch.zeros(3, 12, H * D,
                                               dtype=torch.bfloat16),
                               torch.zeros(3, 12, H * D,
                                           dtype=torch.bfloat16),
                               None, None, starts, pages, 0.1)
