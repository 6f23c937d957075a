"""Per-ray exact first hit through (ray, tile) pair walks (kernel K10).

Counterpart of audiblelight_tpu/ops/pair_first_hit.py, on the tiles of
ops/sorted_first_hit.build_sorted_tiles. Where the reference's K9 culls per
block of 512 rays, this route culls per ray, tile by tile, in rounds:

- the slab test of every (ray, tile) pair gives the entry distance into the
  tile's tight box (+inf where the ray's line misses it);
- each round takes each ray's K untested tiles of least entry (the first K
  of a stable sort, as XLA's TopK breaks ties) and marks a candidate live
  where its entry does not pass the ray's best hit at the round's start;
  every live tile is tested and all K candidates are consumed;
- rounds repeat while a ray's next untested tile enters no later than its
  best hit, so at most ceil(n_tiles / K) rounds run.

The port runs every round of every ray in one launch (`pair_first_hit`,
csrc/pair_first_hit.cu): one thread per ray streams the tiles' boxes through
shared memory, keeps its next candidates in registers, and tests a live tile
by walking that tile's own subtree of `build_pair_tree` (K1 big's walk and
bilinear leaf) from the ray's best hit so far; no sort, no pair layout and no
host read. `cuda_kernels.pair_walk_plain` takes the same steps in PyTorch.
The reference's round structure stays as a plain version of its own
(`pair_rounds`: `round_inputs` lays each round's live pairs out
tile-aligned, `_one_round` tests each against its tile's 256 faces), which
the tests hold against the reference's rounds.

The slab test and the bounds are conservative and ties go to the smallest
sorted index, so the result is the dense big first hit over the sorted
faces. Dead rays and misses report (inf, -1). Neither package wires this
route into its tracer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from audiblelight_tpu_torch.ops.cuda_kernels import (PFH_LANES, FaceBVH, _lex_min, big_keep, build_face_bvh,
                                                     first_hit_pair, pair_tile_plain, tile_entries)
from audiblelight_tpu_torch.ops.sorted_first_hit import SortedTiles, _rays, padded_sorted_tris

_BIG = 3.0e38
_IDX_BIG = 2**30


def build_pair_tree(tiles: SortedTiles, tris: np.ndarray, order: np.ndarray) -> FaceBVH:
    """The face tree K10 walks, over the rows of `tiles.face_tab` (from
    `build_sorted_tiles(tris)`, which gave `order`), on the tiles' device:
    the sentinel-padded sorted faces centred on `tiles.center`, in their own
    order (no re-sort), so tile t's 256 rows are leaves 64 t ... 64 t + 63
    and its subtree is rooted at node n_leaves / 64 + t. K1 big's keep rule
    and boxes: the zero padding and sentinel rows report -1 and add nothing
    to a box; each row reports its sorted index."""
    padded = torch.as_tensor(padded_sorted_tris(tris, order, tiles.n_tiles), device=tiles.face_tab.device)
    return build_face_bvh(padded - tiles.center, tiles.face_tab, big_keep(tiles.face_tab), in_order=True)


def _tile_entries(tiles: SortedTiles, o_c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(R, T) entry distance of each ray into each tile's box, +inf where the
    ray's line misses it (`cuda_kernels.tile_entries`)."""
    return tile_entries(o_c, d, tiles.tile_lo, tiles.tile_hi)


def round_inputs(n_tiles: int, o_c, d, cand_tile, cand_live) -> tuple:
    """The tile-aligned layout of one round, as the reference's
    `_one_round` forms it (pair_first_hit.py:187-253): (o_s, d_s (cap, 3)
    pair rays, zero on padding lanes; blk_tile (cap / PFH_LANES,) int32;
    order; slot (n_pairs,), the lane of each sorted pair, cap where dead).

    Live pairs sort stably by tile; each tile's run starts at its padded
    offset; the capacity n_pairs + n_tiles * PFH_LANES holds every run."""
    r, k = cand_tile.shape
    dev = o_c.device
    n_pairs = r * k
    pair_ray = torch.arange(r, device=dev).repeat_interleave(k)
    pair_tile = torch.where(cand_live, cand_tile, n_tiles).reshape(-1)
    counts = torch.bincount(pair_tile, minlength=n_tiles + 1)[:n_tiles]
    padded = -(-counts // PFH_LANES) * PFH_LANES
    offsets = torch.cat([torch.zeros(1, dtype=padded.dtype, device=dev), torch.cumsum(padded, 0)])
    cap = -(-(n_pairs + n_tiles * PFH_LANES) // PFH_LANES) * PFH_LANES

    order = torch.argsort(pair_tile, stable=True)
    sorted_tile = pair_tile[order]
    pos_in_run = torch.arange(n_pairs, device=dev) - torch.searchsorted(sorted_tile, sorted_tile, side="left")
    slot = torch.where(sorted_tile < n_tiles, offsets[sorted_tile.clamp_max(n_tiles - 1)] + pos_in_run, cap)
    slot_to_pair = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    slot_to_pair[slot] = order  # the dead pairs all land on the dropped lane `cap`
    slot_to_pair = slot_to_pair[:cap]

    ray_of_slot = torch.where(slot_to_pair >= 0, pair_ray[slot_to_pair.clamp_min(0)], 0)
    dead = (slot_to_pair < 0)[:, None]
    o_s = torch.where(dead, 0.0, o_c[ray_of_slot]).contiguous()
    d_s = torch.where(dead, 0.0, d[ray_of_slot]).contiguous()

    # Block b serves the tile whose padded range holds lane b * PFH_LANES;
    # blocks past every range get -1
    block_start = torch.arange(cap // PFH_LANES, device=dev) * PFH_LANES
    blk_tile = torch.searchsorted(offsets[1:], block_start, side="right")
    blk_tile = torch.where(blk_tile >= n_tiles, -1, blk_tile).to(torch.int32)
    return o_s, d_s, blk_tile, order, slot


def _one_round(kernel, tiles: SortedTiles, o_c, d, cand_tile, cand_live) -> tuple:
    """Each ray against its K candidate tiles: its best (t, sorted face),
    (inf, 2**30) where no live candidate holds a hit."""
    r, k = cand_tile.shape
    o_s, d_s, blk_tile, order, slot = round_inputs(tiles.n_tiles, o_c, d, cand_tile, cand_live)
    t_slot, i_slot = kernel(o_s, d_s, blk_tile, tiles.face_tab)
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot.clamp_max(o_s.shape[0] - 1)
    t_pair = t_slot[pair_slot].reshape(r, k)
    i_pair = i_slot[pair_slot].reshape(r, k)
    # Dead pairs may alias a live lane: mask them; misses carry 3e38
    t_pair = torch.where(cand_live & (t_pair < _BIG) & (t_pair > 0), t_pair, math.inf)
    i_pair = torch.where(cand_live & (i_pair >= 0), i_pair, _IDX_BIG)
    t_best = t_pair.amin(dim=1)
    return t_best, torch.where(t_pair == t_best[:, None], i_pair, _IDX_BIG).amin(dim=1)


def _pair_tree(tiles: SortedTiles) -> FaceBVH:
    if tiles.pair_tree is None:
        raise ValueError(f"{tiles} carry no pair tree: build_sorted_tiles builds one (build_pair_tree)")
    return tiles.pair_tree


def pair_first_hit(tiles: SortedTiles, origins: torch.Tensor, dirs: torch.Tensor, alive=None, k_slots: int = 8):
    """First hit (t (R,), sorted face (R,) int32) of each ray against the
    Morton-tiled mesh, in rounds of `k_slots` nearest tiles per ray; `alive`
    (R,) bool, all live by default. Dead rays and misses give (inf, -1).
    One launch of the K10 kernel on a CUDA device (the tiles' `pair_tree`
    walked tile by tile), its plain walk on the CPU; equals the dense big
    first hit over the sorted faces bit for bit."""
    o, d, alive = _rays(origins, dirs, alive)
    return first_hit_pair(o, d, alive, tiles.center, tiles.tile_lo, tiles.tile_hi, _pair_tree(tiles), k_slots)


def pair_walk(tiles: SortedTiles, origins: torch.Tensor, dirs: torch.Tensor, alive=None, k_slots: int = 8):
    """`pair_first_hit` with the walk's counts: (t, face, stats). stats holds
    the rounds (int), the live (ray, tile) pairs tested, the rays unresolved
    after the first round, the (ray, tile) pairs whose box the ray's line
    enters no later than its hit (each ray's ideal walk), as `pair_rounds`
    counts them, and `counts`, the kernel's (R, 4) int32 per-ray rounds,
    live pairs, subtree box tests and leaves folded."""
    o, d, alive = _rays(origins, dirs, alive)
    r, dev = o.shape[0], o.device
    counts = torch.empty((r, 4), dtype=torch.int32, device=dev)
    t, idx = first_hit_pair(o, d, alive, tiles.center, tiles.tile_lo, tiles.tile_hi, _pair_tree(tiles), k_slots,
                            counts)
    live = torch.ones(r, dtype=torch.bool, device=dev) if alive is None else alive
    enter = torch.where(live[:, None], _tile_entries(tiles, o - tiles.center, d), math.inf)
    rounds = counts[:, 0]
    return t, idx, dict(rounds=max(1, int(rounds.max())) if r else 1, pairs=counts[:, 1].sum(dtype=torch.int64),
                        unresolved_first=(rounds > 1).sum(),
                        needed=((enter <= t[:, None]) & torch.isfinite(enter)).sum(), counts=counts)


def pair_rounds(tiles: SortedTiles, origins: torch.Tensor, dirs: torch.Tensor, alive=None, k_slots: int = 8):
    """The reference's rounds in plain PyTorch (any device): each round's
    live pairs laid out tile-aligned and tested against their tiles' 256
    faces (`pair_tile_plain`), one host read per round: (t, face, stats),
    stats as `pair_walk` gives them without `counts`."""
    origins = torch.atleast_2d(origins).to(torch.float32)
    dirs = torch.atleast_2d(dirs).to(torch.float32)
    r, dev = origins.shape[0], origins.device
    alive = torch.ones(r, dtype=torch.bool, device=dev) if alive is None else alive.to(torch.bool)
    o_c = origins - tiles.center
    enter = torch.where(alive[:, None], _tile_entries(tiles, o_c, dirs), math.inf)
    enter0 = enter.clone()
    k = min(k_slots, tiles.n_tiles)
    best_t = torch.full((r,), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((r,), _IDX_BIG, dtype=torch.int32, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    rounds, unresolved_first = 0, None
    while True:
        # The K nearest untested tiles, ties to the lower tile id
        cand_enter, cand = torch.sort(enter, dim=1, stable=True)
        cand_enter, cand = cand_enter[:, :k], cand[:, :k]
        # <= keeps the tie rule: an entry equal to the best t could hold an
        # equal-t hit with a smaller face index
        cand_live = torch.isfinite(cand_enter) & (cand_enter <= best_t[:, None])
        pairs += cand_live.sum()
        t_r, i_r = _one_round(pair_tile_plain, tiles, o_c, dirs, cand, cand_live)
        best_t, best_i = _lex_min(best_t, best_i, t_r, i_r)
        enter.scatter_(1, cand, math.inf)  # every candidate consumed, live or not (in place)
        next_enter = enter.amin(dim=1)
        unresolved = (next_enter <= best_t) & torch.isfinite(next_enter)
        rounds += 1
        if unresolved_first is None:
            unresolved_first = unresolved.sum()
        if not bool(unresolved.any()):
            break
    t = torch.where(torch.isfinite(best_t) & alive, best_t, math.inf)
    idx = torch.where(torch.isfinite(t), best_i, -1)
    return t, idx, dict(rounds=rounds, pairs=pairs, unresolved_first=unresolved_first,
                        needed=((enter0 <= t[:, None]) & torch.isfinite(enter0)).sum())
