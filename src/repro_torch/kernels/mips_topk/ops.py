"""mips_topk wrapper: a CPU tensor runs the plain version, a CUDA tensor
launches the two-pass kernel of ``csrc/mips_topk.cu`` or raises.

For k <= ``MAX_K`` the wrapper picks the item chunking of pass 1
(``chunking``) and allocates the per-chunk top-k lists pass 2 merges.  A
larger k (up to N) takes the select route: pass 1 writes every score of a
chunk of queries into a scratch (``select_rows`` queries at a time, at most
``SCRATCH_FLOATS``), and a block per query selects its top k from it.
With ``scales`` the items are the int8 store's codes (the ``*_i8``
entries).  ``mips_topk.launches`` and ``mips_topk.launches_int8`` count the
fp32 and int8 kernels of the k <= 32 route, ``launches_select`` and
``launches_select_int8`` those of the select route."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.mips_topk.ref import mips_topk_ref

QUERY_TILE = 128   # queries per pass-1 block (kBQ in csrc/mips_topk.cu)
ITEM_TILE = 128    # items per pass-1 tile (kBN)
BLOCKS_PER_SM = 2  # pass-1 blocks an SM holds (__launch_bounds__ and shared memory)
MAX_K = 32         # kMaxK: pass 1 keeps 128 top-k lists in shared memory
SCRATCH_FLOATS = 1 << 26  # the select route's score scratch: 256 MiB
MAX_CANDIDATES = 4096  # chunks * k that pass 2 ranks in shared memory
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


def select_rows(b: int, n: int) -> int:
    """Queries a pass of the select route scores at once: as many as fit
    the scratch, at least one."""
    return max(1, min(b, SCRATCH_FLOATS // n))


def mips_topk(queries: torch.Tensor, items: torch.Tensor,
              scales: "torch.Tensor | None" = None, *, k: int = 10):
    """Exact top-k MIPS: (scores [B, k] fp32, ids [B, k] int32).  With
    ``scales`` ([N] fp32), ``items`` are int8 codes and the scores are
    ``(q . codes) * scale``."""
    if not _lib.on_cuda(queries):
        return mips_topk_ref(queries, items, k=k, scales=scales)
    check_kernel_inputs(queries, items, scales, k)
    dev = queries.device
    b, d = queries.shape
    n = items.shape[0]
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_s, out_i
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if k > MAX_K:
        rows = select_rows(b, n)
        chunks, per_chunk = chunking(rows, n, 1, sms)
        scratch = torch.empty((rows, n), dtype=torch.float32, device=dev)
        tail = (b, n, d, k, rows, chunks, per_chunk, scratch.data_ptr(), out_s.data_ptr(),
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
        return out_s, out_i
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
