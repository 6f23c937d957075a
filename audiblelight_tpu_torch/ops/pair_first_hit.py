"""Per-ray exact first hit through (ray, tile) pair walks (kernel K10).

Counterpart of audiblelight_tpu/ops/pair_first_hit.py, on the tiles of
ops/sorted_first_hit.build_sorted_tiles. Where the reference's K9 culls
per block of 512 rays, this route culls per ray, tile by tile:

- `_tile_entries`: a slab test of every (ray, tile) pair, the entry distance
  into the tile's box (+inf where the ray's line misses it), streamed by
  axis;
- each round takes each ray's K untested tiles of least entry (the first K
  of a stable sort, as XLA's TopK breaks ties) and marks a candidate live
  where its entry does not pass the ray's best hit so far;
- `_one_round` lays the live pairs out tile-aligned (pairs sorted by tile,
  each tile's run padded to whole blocks of PFH_LANES), so every kernel
  block tests its lanes' rays against one tile's 256 faces, then takes each
  ray's smallest (t, sorted face) over its K lanes;
- rounds repeat while a ray's next untested tile enters no later than its
  best hit; all K candidates are consumed each round, so at most
  ceil(n_tiles / K) rounds run. Each round reads one flag to the host.

The slab test and the bounds are conservative and ties go to the smallest
sorted index, so the result is the dense big first hit over the sorted
faces. Dead rays and misses report (inf, -1). Neither package wires this
route into its tracer.
"""

from __future__ import annotations

import math

import torch

from audiblelight_tpu_torch.ops.cuda_kernels import PFH_LANES, _lex_min, first_hit_pair, pair_tile_plain
from audiblelight_tpu_torch.ops.sorted_first_hit import SortedTiles

_BIG = 3.0e38
_IDX_BIG = 2**30


def _tile_entries(tiles: SortedTiles, o_c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(R, T) entry distance of each ray into each tile's box, +inf where the
    ray's line misses it; directions under 1e-12 in size count as +-1e-12."""
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    inv = 1.0 / torch.where(d.abs() < 1e-12, tiny, d)
    r, n_t = o_c.shape[0], tiles.tile_lo.shape[0]
    ent = torch.zeros((r, n_t), dtype=torch.float32, device=o_c.device)
    exi = torch.full((r, n_t), math.inf, dtype=torch.float32, device=o_c.device)
    for ax in range(3):
        t0 = (tiles.tile_lo[None, :, ax] - o_c[:, ax, None]) * inv[:, ax, None]
        t1 = (tiles.tile_hi[None, :, ax] - o_c[:, ax, None]) * inv[:, ax, None]
        ent = torch.maximum(ent, torch.minimum(t0, t1))
        exi = torch.minimum(exi, torch.maximum(t0, t1))
    return torch.where(exi >= ent, ent, math.inf)


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


def _pair_query(kernel, tiles: SortedTiles, origins, dirs, alive, k_slots: int, counted: bool = False) -> tuple:
    """(t (R,), sorted face (R,), stats) through `kernel`. With `counted`,
    stats holds the rounds (int) and, on the device, the live (ray, tile)
    pairs tested, the rays unresolved after the first round, and the (ray,
    tile) pairs whose box the ray's line enters no later than its hit (each
    ray's ideal walk); else it is empty."""
    origins = torch.atleast_2d(origins).to(torch.float32)
    dirs = torch.atleast_2d(dirs).to(torch.float32)
    r, dev = origins.shape[0], origins.device
    alive = torch.ones(r, dtype=torch.bool, device=dev) if alive is None else alive.to(torch.bool)
    o_c = origins - tiles.center
    enter = torch.where(alive[:, None], _tile_entries(tiles, o_c, dirs), math.inf)
    enter0 = enter.clone() if counted else None
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
        if counted:
            pairs += cand_live.sum()
        t_r, i_r = _one_round(kernel, tiles, o_c, dirs, cand, cand_live)
        best_t, best_i = _lex_min(best_t, best_i, t_r, i_r)
        enter.scatter_(1, cand, math.inf)  # every candidate consumed, live or not (in place)
        next_enter = enter.amin(dim=1)
        unresolved = (next_enter <= best_t) & torch.isfinite(next_enter)
        rounds += 1
        if counted and unresolved_first is None:
            unresolved_first = unresolved.sum()
        if not bool(unresolved.any()):
            break
    t = torch.where(torch.isfinite(best_t) & alive, best_t, math.inf)
    idx = torch.where(torch.isfinite(t), best_i, -1)
    if not counted:
        return t, idx, {}
    return t, idx, dict(rounds=rounds, pairs=pairs, unresolved_first=unresolved_first,
                        needed=((enter0 <= t[:, None]) & torch.isfinite(enter0)).sum())


def pair_first_hit(tiles: SortedTiles, origins: torch.Tensor, dirs: torch.Tensor, alive=None, k_slots: int = 8):
    """First hit (t (R,), sorted face (R,) int32) of each ray against the
    Morton-tiled mesh, in rounds of `k_slots` nearest tiles per ray; `alive`
    (R,) bool, all live by default. Dead rays and misses give (inf, -1).
    Runs the K10 kernel on a CUDA device and its plain version on the CPU;
    equals the dense big first hit over the sorted faces bit for bit."""
    t, idx, _ = _pair_query(first_hit_pair, tiles, origins, dirs, alive, k_slots)
    return t, idx


def pair_walk(tiles: SortedTiles, origins: torch.Tensor, dirs: torch.Tensor, alive=None, k_slots: int = 8,
              kernel=pair_tile_plain):
    """`pair_first_hit` with the walk's counts: (t, face, stats), stats as
    `_pair_query` gives them. Each round runs `kernel`, the plain version
    unless given another with `first_hit_pair`'s arguments and result."""
    return _pair_query(kernel, tiles, origins, dirs, alive, k_slots, counted=True)
