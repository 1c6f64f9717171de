"""The launch plans of the int8_dot and batch_gather kernels, on the CPU.

Each kernel's geometry and branch are chosen in Python before the launch
(``ops/int8.py:int8_plan``, ``ops/batch_gather.py:batch_plan``) and passed
to its C entry point, so they are pinned here without a card:

- ``int8_plan``: for every batch of 1-32 rows at model C's 2048 -> 32
  ``fc``, the fewest output columns per block whose grid fits one block
  per SM, a thread per 16 elements of K, the 16-byte branch; the scalar
  branch for K % 16 != 0 (K % 4 != 0 included) and for x or q views that
  are not 16-byte aligned; several chunks a thread past K = 4096.
- ``batch_plan``: for every batch of 1-32 rows at 100x250, one float4 a
  thread (25 blocks a row) within one wave of resident blocks; the scalar
  branch for a row that is no multiple of 4 and for 4-byte offset views
  of x or out_x; larger batches cut to one wave.
- The wrappers on CPU tensors take the plain versions and launch nothing,
  and the kernel library's hash covers the headers the sources include.

tests/test_torch_port_cuda.py holds both kernels to their plain versions
on the card.
"""

import pytest
import torch

from dasmtl_torch.ops import _build, batch_gather, int8

SMS = 132  # an H100 SXM
K, N = 2048, 32  # model C's int8 fc


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These shapes gain nothing from intra-op threads, and the suite runs
    several test processes on one host: one thread each keeps them from
    starving one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    int8.launches.reset()
    batch_gather.launches.reset()
    yield
    torch.set_num_threads(n)


def _expected_cols(rows, n=N):
    for c in (1, 2, 4, 8):
        if rows * -(-n // c) <= SMS:
            return c
    return 8


@pytest.mark.parametrize("rows", range(1, 33))
def test_int8_plan_at_every_serving_batch(rows):
    plan = int8.int8_plan(rows, K, N, 0, 256, SMS)
    assert plan == (128, _expected_cols(rows), True)
    blocks = rows * -(-N // plan.cols)
    assert blocks <= SMS or plan.cols == 8
    # A block of 128 threads x 16 elements covers K = 2048 in one chunk.
    assert plan.threads * int8.PER_THREAD == K


@pytest.mark.parametrize("rows,cols", [(1, 1), (4, 1), (5, 2), (8, 2),
                                       (9, 4), (16, 4), (17, 8), (32, 8),
                                       (33, 8), (256, 8)])
def test_int8_plan_columns_per_block(rows, cols):
    assert int8.int8_plan(rows, K, N, 0, 0, SMS).cols == cols


@pytest.mark.parametrize("n,rows,cols", [(5, 32, 2), (33, 32, 8),
                                         (33, 4, 1), (1, 1, 1)])
def test_int8_plan_column_counts_off_the_group(n, rows, cols):
    """N need not be a multiple of the group: the last block masks."""
    plan = int8.int8_plan(rows, K, n, 0, 0, SMS)
    assert plan.cols == cols


@pytest.mark.parametrize("k,threads,vec", [
    (37, 32, False),      # K % 4 != 0
    (2050, 160, False),   # K % 4 != 0 at serving width
    (2052, 160, False),   # K % 4 == 0 but K % 16 != 0
    (2064, 160, True),
    (16, 32, True),
    (4096, 256, True),
    (32768, 256, True)])  # 8 chunks a thread
def test_int8_plan_odd_k_and_long_rows(k, threads, vec):
    plan = int8.int8_plan(8, k, N, 0, 0, SMS)
    assert (plan.threads, plan.vec) == (threads, vec)
    assert plan.threads % 32 == 0 and plan.threads <= int8.MAX_THREADS


@pytest.mark.parametrize("x_off,q_off", [(4, 0), (0, 1), (0, 4), (8, 8)])
def test_int8_plan_unaligned_pointers_take_the_scalar_branch(x_off, q_off):
    x = torch.zeros(4 * K + 4)
    q = torch.zeros(N * K + 16, dtype=torch.int8)
    xv = x[x_off // 4:x_off // 4 + 4 * K].view(4, K)
    qv = q[q_off:q_off + N * K].view(N, K)
    assert xv.is_contiguous() and qv.is_contiguous()
    aligned = xv.data_ptr() % 16 == 0 and qv.data_ptr() % 16 == 0
    plan = int8.int8_plan(4, K, N, xv.data_ptr(), qv.data_ptr(), SMS)
    assert plan.vec is aligned
    assert not plan.vec  # every offset above breaks 16-byte alignment


@pytest.mark.parametrize("b", range(1, 33))
def test_batch_plan_at_every_batch(b):
    row = 100 * 250
    plan = batch_gather.batch_plan(row, b, 0, 1 << 20, SMS)
    assert plan == (True, 256, 25)
    wave = SMS * batch_gather.THREADS_PER_SM // plan.threads
    assert b * plan.blocks <= wave  # one wave: 800 of 1,056 at B = 32


@pytest.mark.parametrize("b,blocks", [(42, 25), (43, 24), (64, 16),
                                      (1056, 1), (5000, 1)])
def test_batch_plan_cuts_large_batches_to_one_wave(b, blocks):
    plan = batch_gather.batch_plan(100 * 250, b, 0, 0, SMS)
    assert plan.blocks == blocks


@pytest.mark.parametrize("row,vec,blocks", [(7 * 13, False, 1),
                                            (4 * 13, True, 1),
                                            (64 * 64, True, 4),
                                            (100 * 250 + 2, False, 33)])
def test_batch_plan_row_lengths(row, vec, blocks):
    plan = batch_gather.batch_plan(row, 32, 0, 0, SMS)
    assert (plan.vec, plan.blocks) == (vec, blocks)


@pytest.mark.parametrize("x_off,out_off", [(4, 0), (0, 4), (12, 12)])
def test_batch_plan_offset_views_take_the_scalar_branch(x_off, out_off):
    x = torch.zeros(8 * 100 + 4)
    out = torch.zeros(4 * 100 + 4)
    xv = x[x_off // 4:x_off // 4 + 800].view(8, 100)
    ov = out[out_off // 4:out_off // 4 + 400].view(4, 100)
    assert xv.is_contiguous() and ov.is_contiguous()
    plan = batch_gather.batch_plan(100, 4, xv.data_ptr(), ov.data_ptr(), SMS)
    assert not plan.vec


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 37, generator=g)
    q = torch.randint(-127, 128, (5, 37), generator=g).to(torch.int8)
    scale, bias = torch.rand(5, generator=g), torch.randn(5, generator=g)
    assert torch.equal(int8.int8_dot(x, q, scale, bias),
                       int8.int8_dot_plain(x, q, scale, bias))
    data = torch.randn(6, 4, 5, 1, generator=g)
    d = torch.arange(6, dtype=torch.int32)
    idx = torch.tensor([5, 0, 0], dtype=torch.int32)
    w = torch.tensor([1.0, 1.0, 0.0])
    got = batch_gather.batch_gather(data, d, d, idx, w)
    want = batch_gather.batch_gather_plain(data, d, d, idx, w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int8.launches.value == 0 and batch_gather.launches.value == 0


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path() != first
    assert [p.name for p in _build._sources()] == ["k.cu"]
