"""The paged KV write of the PyTorch port: ``ops.paged_kv_write`` writes a
chunk's new K/V into the page pools in place.  Its plain version (the
CPU's) against the two functions the model called before the kernel
existed, kept here verbatim as the yardstick; on a CUDA card only, the
kernel against the plain version, bitwise (it is a copy).

Cases: chunks of 1 and 16 lanes, pools of 4 heads (MHA) and of 2 (the
K/V heads of a GQA model), a frozen row (length 0), a row whose chunk
runs onto a page of -1, a chunk that crosses a page boundary, f32 and
bf16.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_kv_write as kv_write_mod  # noqa: E402


def _write_index_yardstick(page_table, positions, valid, page_size):
    logical = (positions // page_size).clamp(0, page_table.shape[1] - 1)
    phys = torch.gather(page_table, 1, logical.long())
    rows = (valid & (phys >= 0)).flatten().nonzero().squeeze(1)
    return (rows, phys.flatten()[rows].long(),
            (positions % page_size).flatten()[rows].long())


def _update_yardstick(k_pages, v_pages, index, k_new, v_new):
    rows, phys, off = index
    b, h, c, hd = k_new.shape
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        flat = new.transpose(1, 2).reshape(b * c, h, hd)
        pages[phys, :, off, :] = flat.index_select(0, rows).to(pages.dtype)


def _yardstick(k_pages, v_pages, k_new, v_new, table, start, lens):
    """What ``Model._chunk_hidden`` wrote before the kernel: positions
    and validity from the chunk's starts and lengths, then the filter
    and the indexed write."""
    c = k_new.shape[2]
    steps = torch.arange(c, dtype=torch.int32)
    positions = start[:, None] + steps[None, :]
    valid = steps[None, :] < lens[:, None]
    index = _write_index_yardstick(table, positions, valid,
                                   k_pages.shape[2])
    _update_yardstick(k_pages, v_pages, index, k_new, v_new)


PS, MP, NP = 4, 6, 20


def _case(c: int, h: int, d: int, dtype, seed: int = 0):
    """Pools filled with noise, a table over them and four rows: row 0
    frozen; row 1 starting one token before a page boundary; row 2 whose
    chunk runs onto a -1 page; row 3 from position 0.  K/V come as the
    model makes them: (B, H, C, D) views of (B, C, H, D) projections
    (V with other strides than K)."""
    g = torch.Generator().manual_seed(seed)
    pages = [torch.randn(NP, h, PS, d, generator=g).to(dtype)
             for _ in range(2)]
    table = torch.full((4, MP), -1, dtype=torch.int32)
    perm = torch.randperm(NP, generator=g).int()
    table[0, :3] = perm[0:3]
    table[1, :MP] = perm[3:3 + MP]
    table[2, :1] = perm[9:10]           # the rest of row 2 unallocated
    table[3, :MP] = perm[10:10 + MP]
    start = torch.tensor([5, PS - 1, 1, 0], dtype=torch.int32)
    lens = torch.tensor([0, c, c, min(c, 3)], dtype=torch.int32)
    k_new = torch.randn(4, c, h, d, generator=g).to(dtype).transpose(1, 2)
    v_new = torch.randn(4, h, c, d, generator=g).to(dtype)
    return pages, k_new, v_new, table, start, lens


CASES = [(c, h, d, dtype) for c in (1, 16) for h, d in ((4, 8), (2, 16))
         for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("c,h,d,dtype", CASES)
def test_plain_version_writes_what_the_filtered_scatter_wrote(c, h, d,
                                                              dtype):
    (kp, vp), k_new, v_new, table, start, lens = _case(c, h, d, dtype)
    want_k, want_v = kp.clone(), vp.clone()
    _yardstick(want_k, want_v, k_new, v_new, table, start, lens)
    before = ops.launch_counts()
    assert ops.paged_kv_write(kp, vp, k_new, v_new, table, start,
                              lens) is None
    assert ops.launch_counts() == before    # the CPU launches nothing
    assert torch.equal(kp, want_k) and torch.equal(vp, want_v)
    # the frozen row and the -1 pages changed nothing; the others did
    written = (kp != _case(c, h, d, dtype)[0][0]).any(dim=(1, 2, 3))
    assert not written[table[0, :3].long()].any()
    assert written[table[1, 0].long()] and written[table[3, 0].long()]
    assert written[table[1, 1].long()] == (c > 1)   # across the boundary


def test_plain_version_drops_every_lane_of_frozen_rows():
    (kp, vp), k_new, v_new, table, start, _ = _case(16, 4, 8, torch.float32)
    k0, v0 = kp.clone(), vp.clone()
    ops.paged_kv_write(kp, vp, k_new, v_new, table, start,
                       torch.zeros(4, dtype=torch.int32))
    assert torch.equal(kp, k0) and torch.equal(vp, v0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches its kernel or raises: it never writes on the
    CPU in the kernel's place."""
    (kp, vp), k_new, v_new, table, start, lens = _case(1, 4, 8,
                                                       torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kv_write_mod.paged_kv_write(kp, vp, k_new, v_new, table, start,
                                    lens)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,d,dtype", CASES + [
    (1, 32, 128, torch.bfloat16), (16, 8, 128, torch.bfloat16),
    (16, 4, 112, torch.bfloat16), (3, 2, 7, torch.float32)])
def test_kernel_equals_plain_version_bitwise(cuda, c, h, d, dtype):
    """At the smoke widths, qwen7b's and qwen32b's K/V heads, zamba2's
    D 112 and an odd D (4-byte units); one launch a call."""
    (kp, vp), k_new, v_new, table, start, lens = _case(c, h, d, dtype)
    want_k, want_v = kp.clone(), vp.clone()
    ref.paged_kv_write_ref(want_k, want_v, k_new, v_new, table, start, lens)
    args = [t.to(cuda) for t in (kp, vp)]
    k_dev = k_new.transpose(1, 2).contiguous().to(cuda).transpose(1, 2)
    v_dev = v_new.to(cuda)
    ops.reset_launch_counts()
    ops.paged_kv_write(*args, k_dev, v_dev,
                       *(t.to(cuda) for t in (table, start, lens)))
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_kv_write"] == 1
    assert torch.equal(args[0].cpu(), want_k)
    assert torch.equal(args[1].cpu(), want_v)


@pytest.mark.cuda
def test_kernel_writes_one_layer_of_a_stacked_pool(cuda):
    """The model hands the kernel one layer's view of the (L, NP, H, ps,
    D) pools: the other layers are untouched."""
    (kp, vp), k_new, v_new, table, start, lens = _case(16, 4, 64,
                                                       torch.bfloat16)
    stack = [torch.stack([t, t.clone(), t.clone()]).to(cuda)
             for t in (kp, vp)]
    before = [t.clone() for t in stack]
    ops.paged_kv_write(stack[0][1], stack[1][1], k_new.to(cuda),
                       v_new.to(cuda),
                       *(t.to(cuda) for t in (table, start, lens)))
    want_k, want_v = kp.clone(), vp.clone()
    ref.paged_kv_write_ref(want_k, want_v, k_new, v_new, table, start, lens)
    for t, b in zip(stack, before):
        assert torch.equal(t[0], b[0]) and torch.equal(t[2], b[2])
    assert torch.equal(stack[0][1].cpu(), want_k)
    assert torch.equal(stack[1][1].cpu(), want_v)


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    (kp, vp), k_new, v_new, table, start, lens = (
        [t.to(cuda) for t in part] if isinstance(part, list) else
        part.to(cuda) for part in _case(1, 4, 8, torch.float32))
    with pytest.raises(TypeError):   # torch's default integer is int64
        kv_write_mod.paged_kv_write(kp, vp, k_new, v_new, table.long(),
                                    start, lens)
    with pytest.raises(TypeError):   # new K/V in another dtype
        kv_write_mod.paged_kv_write(kp, vp, k_new.double(), v_new, table,
                                    start, lens)
    strided = k_new.new_zeros(*k_new.shape[:3], 2 * k_new.shape[3])
    with pytest.raises(ValueError):  # D strided
        kv_write_mod.paged_kv_write(kp, vp, strided[..., ::2], v_new,
                                    table, start, lens)
