"""mips_topk wrapper: a CPU tensor runs the plain version, a CUDA tensor
launches the two-pass kernel of ``csrc/mips_topk.cu`` or raises.

For k <= ``MAX_K`` the wrapper picks the item chunking of pass 1
(``chunking``) and allocates the per-chunk top-k lists pass 2 merges.  A
larger k (up to N) takes the select route (``mips_topk_select``): pass 1
writes every score of a chunk of queries into a scratch (``select_rows``
queries at a time, at most ``SCRATCH_FLOATS``); a histogram pass and a
compaction pass over it keep each row's keys at or above its threshold bin
in a candidate buffer (``select_plan``), and a block per query sorts them.
With ``scales`` the items are the int8 store's codes (the ``*_i8``
entries).  ``mips_topk.launches`` and ``mips_topk.launches_int8`` count the
fp32 and int8 kernels of the k <= 32 route, ``launches_select`` and
``launches_select_int8`` those of the select route.  ``launch_cost`` and
``select_cost`` give a launch's flops and the bytes it must move."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.mips_topk.ref import mips_topk_ref, select_candidates_ref

QUERY_TILE = 128   # queries per pass-1 block (kBQ in csrc/mips_topk.cu)
ITEM_TILE = 128    # items per pass-1 tile (kBN)
BLOCKS_PER_SM = 2  # pass-1 blocks an SM holds (__launch_bounds__ and shared memory)
MAX_K = 32         # kMaxK: pass 1 keeps 128 top-k lists in shared memory
SCRATCH_FLOATS = 1 << 26  # the select route's score scratch: 256 MiB
MAX_CANDIDATES = 4096  # chunks * k that pass 2 ranks in shared memory
SELECT_BINS = 2048     # kBins: the select's histogram of the key's top 11 bits
SELECT_SLICE = 8192    # scores a block of the select's streaming passes reads
CANDIDATES_MIN = 16384  # candidate keys a row's buffer holds, at least
# what a chunk's first tiles cost beyond their products, in tiles: they merge
# many candidates (measured on an H100: tiles of 10-tile chunks took 1.2x
# those of 134-tile chunks)
CHUNK_START_TILES = 2


def chunking(b: int, n: int, k: int, sms: int):
    """(chunks, items per chunk) for pass 1.  Every chunk but the last is a
    whole number of item tiles and the chunks cover [0, n) once, with at
    most ``MAX_CANDIDATES`` merge candidates per query.  Of those chunk
    counts it takes the fewest that minimise the tiles the busiest block
    slot walks: waves of ``sms * BLOCKS_PER_SM`` blocks times the tiles of
    one chunk plus ``CHUNK_START_TILES``."""
    q_tiles = -(-b // QUERY_TILE)
    n_tiles = -(-n // ITEM_TILE)
    slots = sms * BLOCKS_PER_SM
    best = None
    for want in range(1, max(1, min(n_tiles, MAX_CANDIDATES // k)) + 1):
        per = -(-n_tiles // want)
        chunks = -(-n_tiles // per)
        cost = -(-q_tiles * chunks // slots) * (per + CHUNK_START_TILES)
        if best is None or cost < best[0]:
            best = (cost, chunks, per)
    _, chunks, per = best
    return chunks, per * ITEM_TILE


def check_kernel_inputs(queries: torch.Tensor, items: torch.Tensor,
                        scales: "torch.Tensor | None", k: int) -> None:
    """Raise unless queries [B, d] fp32 and items [N, d] (fp32, or int8 codes
    with [N] fp32 scales) are what a kernel of ``csrc/mips_topk.cu`` takes,
    contiguous on one device, with 1 <= k <= N."""
    dev = queries.device
    b, d = queries.shape
    n = items.shape[0]
    _lib.expect(queries, "queries", torch.float32, (b, d), dev)
    if scales is None:
        _lib.expect(items, "items", torch.float32, (n, d), dev)
    else:
        _lib.expect(items, "codes", torch.int8, (n, d), dev)
        _lib.expect(scales, "scales", torch.float32, (n,), dev)
    if not 1 <= k <= n:
        raise ValueError(f"mips_topk takes 1 <= k <= N={n}, got {k}")


def launch_cost(b: int, n: int, d: int, k: int, int8: bool = False):
    """(flops, bytes) of the top k of B queries over N items: the queries
    and the items (int8: codes and scales) read once, scores and ids
    written; 2 d flops a score, and one more for an int8 scale."""
    row_bytes = d + 4 if int8 else d * 4
    return 2.0 * b * n * d + (b * n if int8 else 0), b * d * 4 + n * row_bytes + b * k * 8


def select_cost(b: int, n: int, k: int, candidates: int):
    """(flops, bytes) of the select route's selection after its scan: the
    score scratch read twice, ``candidates`` keys (8 bytes each) and the
    top k written."""
    return 0.0, 2 * b * n * 4 + candidates * 8 + b * k * 8


def _topk_entry_cost(int8: bool):
    def cost(*args):
        b, n, d, k = args[3:7] if int8 else args[2:6]
        return (*launch_cost(b, n, d, k, int8), "fp32")
    return cost


def _select_entry_cost(int8: bool):
    """The scan, then the selection with every row's candidate buffer full
    (``select_plan``'s cap: the kernel's count is data)."""
    def cost(*args):
        b, n, d, k, _, _, _, _, cap = args[3:12] if int8 else args[2:11]
        flops, nbytes = launch_cost(b, n, d, k, int8)
        return flops, nbytes + select_cost(b, n, k, b * cap)[1], "fp32"
    return cost


_lib.COSTS.update(mips_topk_f32=_topk_entry_cost(False), mips_topk_i8=_topk_entry_cost(True),
                  mips_topk_select_f32=_select_entry_cost(False),
                  mips_topk_select_i8=_select_entry_cost(True))


def select_rows(b: int, n: int) -> int:
    """Queries a pass of the select route scores at once: as many as fit
    the scratch, at least one."""
    return max(1, min(b, SCRATCH_FLOATS // n))


def select_plan(n: int, k: int):
    """(per, cap) of the select route: the scores of a row each block of
    its two streaming passes reads (the row's slices are ``ceil(n / per)``
    blocks), and the candidate keys a row's buffer holds.  A row whose
    candidates pass ``cap`` is selected from its score row instead."""
    return min(n, SELECT_SLICE), min(n, max(CANDIDATES_MIN, 2 * k))


def mips_topk_select(queries: torch.Tensor, items: torch.Tensor,
                     scales: "torch.Tensor | None" = None, *, k: int):
    """The select route at any 1 <= k <= N: (scores [B, k] fp32, ids [B, k]
    int32, candidates [B] int32), where ``candidates`` counts each row's
    keys at or above its threshold bin (more than ``select_plan``'s cap:
    the row was selected from its scores)."""
    if not _lib.on_cuda(queries):
        s, i = mips_topk_ref(queries, items, k=k, scales=scales)
        return s, i, select_candidates_ref(queries, items, k=k, scales=scales)[1]
    check_kernel_inputs(queries, items, scales, k)
    dev = queries.device
    b, d = queries.shape
    n = items.shape[0]
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    counts = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i, counts
    sms = _lib.sm_count(dev)
    rows = select_rows(b, n)
    chunks, per_chunk = chunking(rows, n, 1, sms)
    per, cap = select_plan(n, k)
    scratch = torch.empty((rows, n), dtype=torch.float32, device=dev)
    hist = torch.empty((rows, SELECT_BINS), dtype=torch.int32, device=dev)
    thresh = torch.empty(rows, dtype=torch.int32, device=dev)
    cands = torch.empty((rows, cap), dtype=torch.int64, device=dev)
    tail = (b, n, d, k, rows, chunks, per_chunk, per, cap, scratch.data_ptr(), hist.data_ptr(),
            thresh.data_ptr(), counts.data_ptr(), cands.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), _lib.stream(dev))
    if scales is None:
        rc = _lib.lib().mips_topk_select_f32(queries.data_ptr(), items.data_ptr(), *tail)
        _lib.check(rc, "mips_topk (select)")
        mips_topk.launches_select += 1
    else:
        rc = _lib.lib().mips_topk_select_i8(queries.data_ptr(), items.data_ptr(),
                                            scales.data_ptr(), *tail)
        _lib.check(rc, "mips_topk (select, int8)")
        mips_topk.launches_select_int8 += 1
    return out_s, out_i, counts


def mips_topk(queries: torch.Tensor, items: torch.Tensor,
              scales: "torch.Tensor | None" = None, *, k: int = 10):
    """Exact top-k MIPS: (scores [B, k] fp32, ids [B, k] int32).  With
    ``scales`` ([N] fp32), ``items`` are int8 codes and the scores are
    ``(q . codes) * scale``."""
    if not _lib.on_cuda(queries):
        return mips_topk_ref(queries, items, k=k, scales=scales)
    if k > MAX_K:
        return mips_topk_select(queries, items, scales, k=k)[:2]
    check_kernel_inputs(queries, items, scales, k)
    dev = queries.device
    b, d = queries.shape
    n = items.shape[0]
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i
    sms = _lib.sm_count(dev)
    chunks, per_chunk = chunking(b, n, k, sms)
    part_s = torch.empty((b, chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, chunks, k), dtype=torch.int32, device=dev)
    tail = (b, n, d, k, chunks, per_chunk, part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), _lib.stream(dev))
    if scales is None:
        rc = _lib.lib().mips_topk_f32(queries.data_ptr(), items.data_ptr(), *tail)
        _lib.check(rc, "mips_topk")
        mips_topk.launches += 1
    else:
        rc = _lib.lib().mips_topk_i8(queries.data_ptr(), items.data_ptr(), scales.data_ptr(),
                                     *tail)
        _lib.check(rc, "mips_topk (int8)")
        mips_topk.launches_int8 += 1
    return out_s, out_i


mips_topk.launches = 0
mips_topk.launches_int8 = 0
mips_topk.launches_select = 0
mips_topk.launches_select_int8 = 0
