"""The rvq_assign kernel's planner and its K-split search, on the CPU.

``ops/mega_kernel.py::_rvq_plan`` picks the kernel's launch (cluster, rows a
tile, persistent clusters, book slots) in pure Python. These tests hold every plan the codec's paths and the card
tests ask for to the kernel's limits: shared memory by ``rvq_smem_bytes``
(the card test ``test_rvq_assign_smem_formula_matches_the_library`` holds it
equal to the library's ``dse_rvq_assign_smem``), slices that cover K
exactly, at most 16 blocks a cluster and 512 threads a block. They then
emulate the kernel's argmin as csrc/rvq_assign.cu takes it: each thread's 4
consecutive codewords by a strict < in ascending order, its row group's
threads merged by the total order (smaller distance, then lower index) over
an xor-shuffle tree, the cluster's blocks' candidates folded by the same
order in rank order, and no finite distance giving index 0. The emulation must equal ``torch.argmin``'s lowest index,
ties across a slice edge and all-inf rows included, and, over the plain
version's distances, give the plain version's codes.
"""

import numpy as np
import pytest
import torch

from dl_speech_enhancement_tpu_torch.ops import mega_kernel as mk

MAX_SMEM = 232448
D, K, L = 64, 1024, 8
# rows of the codec's dispatches (4 a frame): one stream at 1 / 100 / 400
# frames, B streams at 1, 8 and 16 frames, chip_smoke.py's checks and times
PATH_ROWS = sorted({4 * b * n for b in (1, 4, 16, 64) for n in (1, 8, 16)}
                   | {4, 400, 1600, 9600})
# (rows, D, K, L) of the card tests beside the paths' shape
CARD_SHAPES = ((1, 64, 1024, 8), (4, 64, 1024, 8), (256, 64, 1024, 8), (400, 64, 1024, 8),
               (1601, 64, 1024, 8), (4096, 64, 1024, 8), (37, 16, 32, 3), (9, 20, 1000, 2),
               (5, 3, 7, 2), (300, 128, 1024, 8), (64, 256, 512, 4), (1920, 16, 32, 3),
               (100, 256, 1024, 8))


def _check_plan(rows, dim, book_k, n_books):
    plan = mk._rvq_plan(rows, dim, book_k, n_books)
    groups = mk.rvq_groups(book_k, plan.cluster)
    slice_k = 4 * groups
    assert plan.cluster in mk.RVQ_CLUSTERS and plan.cluster <= 16
    # slices [j S, min(K, (j + 1) S)) cover [0, K) and none is empty
    assert plan.cluster * slice_k >= book_k > (plan.cluster - 1) * slice_k
    assert groups <= 32 and groups & (groups - 1) == 0
    assert mk.rvq_smem_bytes(plan.tile, dim, book_k, plan.cluster, plan.stages) <= MAX_SMEM
    assert 1 <= plan.tile <= rows
    threads, cw, rt = mk.rvq_block_threads(plan.tile, book_k, plan.cluster)
    assert threads <= 512 and cw in (2, 4) and rt in (1, 2, 4, 8)
    assert 4 * groups // cw <= 32  # a row group's lanes within a warp
    assert 1 <= plan.clusters <= min(2 * 132 // plan.cluster, -(-rows // plan.tile))
    assert min(2, n_books) <= plan.stages <= n_books
    return plan


@pytest.mark.parametrize("rows", PATH_ROWS)
def test_plan_fits_every_path_site(rows):
    """The three regimes at the paths' widths: up to 112 rows (7 clusters of
    16 at 16 rows) every book resident in clusters of 16; to 464 (29
    clusters of 8 that share SMs two a time, 16 rows each) clusters of 8 on a
    3-slot ring; beyond, the 15 clusters of 8 that run at one block an SM.
    The first two take the single pass; no cluster idles."""
    plan = _check_plan(rows, D, K, L)
    if rows <= 112:
        assert (plan.cluster, plan.stages) == (16, L)
        assert plan.clusters == min(7, -(-rows // 8))
    elif rows <= 464:
        assert (plan.cluster, plan.stages, plan.clusters) == (8, 3, min(29, -(-rows // 8)))
    else:
        assert (plan.cluster, plan.stages) == (8, 3) and plan.clusters <= 15
        assert plan.tile <= 128
    assert mk.rvq_single_pass(plan.tile, D, K, plan.cluster) == (rows <= 464)


@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_fits_the_card_tests_shapes(shape):
    _check_plan(*shape)


@pytest.mark.parametrize("dim,book_k,n_books", [(64, 1024, 8), (16, 32, 3), (20, 1000, 2),
                                                (128, 1024, 8)])
def test_plan_fits_every_row_count(dim, book_k, n_books):
    """Every row count up to 10,000 (the card tests' batched stream, 1,920
    rows of a (3, 16, 32) codebook, among them) gets a plan the kernel
    takes, no more clusters than tiles among them."""
    for rows in range(1, 10001):
        _check_plan(rows, dim, book_k, n_books)


def test_plan_one_stream_one_frame():
    """One frame of one stream: a single cluster of 16 blocks carries the 4
    rows, each block holding 64 codewords of all 8 books."""
    assert tuple(mk._rvq_plan(4, D, K, L)) == (16, 4, 1, 8)


def test_plan_rings_where_the_books_do_not_fit():
    plan = _check_plan(400, 128, 1024, 8)
    assert plan.stages < 8
    # not even 3 slots of 128 codewords fit at D = 256: clusters of 16 with
    # as many slots as fit
    plan = _check_plan(100, 256, 1024, 8)
    assert plan.cluster == 16 and 2 <= plan.stages < 8


@pytest.mark.parametrize("shape", [(4, 1024, 1024, 8), (4, 64, 4096, 8), (0, 64, 1024, 8),
                                   (4, 1025, 8, 2)])
def test_plan_refuses_what_no_plan_fits(shape):
    with pytest.raises(ValueError):
        mk._rvq_plan(*shape)


def test_smem_formula():
    """The byte count the kernel lays out: stages + 2 barriers rounded to 16
    bytes, then stages x S x (D + 1) floats, the residual tile at stride
    round4(D) + 4, and 4 * cluster + 2 words a row (rounded to 4 rows)."""
    assert mk.rvq_smem_bytes(4, 64, 1024, 16, 8) == 80 + 4 * (8 * 64 * 65 + 4 * 68 + 66 * 4)
    assert mk.rvq_smem_bytes(37, 3, 7, 2, 3) == 48 + 4 * (3 * 4 * 4 + 37 * 8 + 10 * 40)


def test_tile_fits_beside_the_books():
    """_rvq_tile_fit gives the largest tile that fits beside the slots: one
    row more would not."""
    for cluster, stages in ((16, L), (8, 3)):
        tile = mk._rvq_tile_fit(D, K, cluster, stages, 4096)
        assert mk.rvq_smem_bytes(tile, D, K, cluster, stages) <= MAX_SMEM < mk.rvq_smem_bytes(
            tile + 1, D, K, cluster, stages)


@pytest.mark.parametrize("tile", [1, 4, 8, 10, 16, 17, 58, 107, 128])
def test_block_threads(tile):
    """Two codewords a thread at one row while 32 lanes a row carry the tile
    in 512 threads, else four at up to 8 rows; the single pass needs
    max(D / 4, cluster) lanes a row."""
    threads, cw, rt = mk.rvq_block_threads(tile, K, 16)
    assert (cw, rt) == ((2, 1) if tile <= 16 else (4, rt))
    assert threads == -(-(64 // cw) * -(-tile // rt) // 32) * 32
    assert mk.rvq_single_pass(tile, D, K, 16) == (tile * 16 <= threads)
    assert not mk.rvq_single_pass(tile, 20, K, 16)  # 5 chunks a row


def _better(d, i, bd, bi):
    return (d < bd) | ((d == bd) & (i < bi))


def _tree(d, i):
    """Merge the last axis (a power of two) as the kernel's xor shuffles do:
    lane x takes lane x ^ off where it is better, for off = n/2 .. 1; every
    lane ends with the same answer, lane 0's is returned."""
    n = d.shape[-1]
    lanes = torch.arange(n)
    off = n // 2
    while off:
        od, oi = d[..., lanes ^ off], i[..., lanes ^ off]
        take = _better(od, oi, d, i)
        d, i = torch.where(take, od, d), torch.where(take, oi, i)
        off //= 2
    return d[..., 0], i[..., 0]


def ksplit_argmin(dist: torch.Tensor, cluster: int) -> torch.Tensor:
    """The kernel's argmin of ``dist`` (rows, K) under a cluster of
    ``cluster`` blocks."""
    rows, book_k = dist.shape
    groups = mk.rvq_groups(book_k, cluster)
    slots = cluster * groups * 4
    pad = torch.full((rows, slots - book_k), float("nan"), dtype=dist.dtype)
    dd = torch.cat([dist, pad], 1).reshape(rows, cluster, groups, 4)
    kk = torch.arange(slots).reshape(cluster, groups, 4).expand(rows, -1, -1, -1)
    bd = torch.full((rows, cluster, groups), float("inf"), dtype=dist.dtype)
    bi = torch.full((rows, cluster, groups), book_k, dtype=torch.long)
    for j in range(4):  # ascending k, strict <, masked past K
        take = (kk[..., j] < book_k) & (dd[..., j] < bd)
        bd, bi = torch.where(take, dd[..., j], bd), torch.where(take, kk[..., j], bi)
    bd, bi = _tree(bd, bi)  # the block's row group
    best_d = torch.full((rows,), float("inf"), dtype=dist.dtype)
    best_i = torch.full((rows,), book_k, dtype=torch.long)
    for j in range(cluster):  # the blocks' candidates, in rank order
        take = _better(bd[:, j], bi[:, j], best_d, best_i)
        best_d, best_i = torch.where(take, bd[:, j], best_d), torch.where(take, bi[:, j], best_i)
    return torch.where(best_i >= book_k, torch.zeros_like(best_i), best_i)


KSPLITS = ((1024, 16), (1024, 8), (1000, 16), (32, 8), (7, 2), (512, 4))


@pytest.mark.parametrize("book_k,cluster", KSPLITS)
def test_ksplit_merge_equals_argmin_with_ties(book_k, cluster):
    """Distances drawn from a few values (so most rows tie) give torch's
    lowest index; ties straddling a slice edge take the lower side."""
    rng = np.random.default_rng(book_k + cluster)
    dist = torch.from_numpy(rng.integers(0, 6, (64, book_k)).astype(np.float32))
    slice_k = 4 * mk.rvq_groups(book_k, cluster)
    for r, edge in enumerate(range(slice_k, book_k, slice_k)):
        dist[r, edge - 1] = dist[r, edge] = -1.0  # a tie across blocks
        dist[r + 32, edge - 1: edge + 1] = torch.tensor([-1.0, -2.0])
    got = ksplit_argmin(dist, cluster)
    assert torch.equal(got, torch.argmin(dist, 1))


@pytest.mark.parametrize("book_k,cluster", KSPLITS)
def test_ksplit_merge_inf_rows(book_k, cluster):
    """All-inf rows give 0, as torch.argmin does; one finite codeword among
    infinities is found wherever it lies."""
    dist = torch.full((book_k + 1, book_k), float("inf"))
    for k in range(book_k):
        dist[k + 1, k] = 3.0
    got = ksplit_argmin(dist, cluster)
    assert torch.equal(got, torch.argmin(dist, 1))
    assert int(got[0]) == 0


def test_ksplit_search_gives_the_plain_codes():
    """The L-stage search with the K-split argmin over the plain version's
    distances gives the plain version's codes."""
    rng = np.random.default_rng(7)
    books = torch.from_numpy(rng.standard_normal((L, D, K)).astype(np.float32)) * 0.3
    sqnorm = (books * books).sum(1)
    z = torch.from_numpy(rng.standard_normal((40, D)).astype(np.float32))
    r, codes = z, []
    for l in range(L):
        dist = (r * r).sum(1, keepdim=True) - 2.0 * (r @ books[l]) + sqnorm[l]
        ind = ksplit_argmin(dist, 16)
        r = r - books[l].t()[ind]
        codes.append(ind + l * K)
    assert torch.equal(torch.stack(codes, 1).to(torch.int32),
                       mk.rvq_assign_plain(z, books, sqnorm))
