"""Synthetic agent zone-trajectory populations at scale — vectorized.

Scale-up of the two-persona mock world to N agents (BASELINE.json configs
2-5): each agent gets a home zone (residential-weighted), a work/education
anchor zone (job-weighted), profile-conditioned departure/return times, an
optional evening stop, and a (N, T) grid of zone ids over the day horizon
plus (N, F) person attributes. Pure numpy, O(N*T), generating 1M agents in
seconds for the pod-scale ladder.
"""
from __future__ import annotations

import numpy as np

from ananke_abm_tpu_torch.data_generator.mock_world import (
    ZONES,
    adjacency_matrix,
    distance_matrix,
    zone_feature_matrix,
)


def generate_agent_population(
    n_agents: int,
    num_times: int = 48,
    seed: int = 0,
    num_zones: int | None = None,
    sparse_world: bool = False,
    world_seed: int | None = None,
):
    """Returns dict with times (T,), zone_ids (N, T) int32, person_feats
    (N, 8) f32, home_zone (N,), zone_features (Z, 7), adj (Z, Z),
    dist (Z, Z).

    ``sparse_world=True`` builds the zone graph as a COO edge list
    (``sparse_zone_world``) and never materializes any (Z, Z) array:
    the dict then has ``edge_index`` (src, dst int32 pairs) with
    ``adj``/``dist`` set to None — the input shape for the edge-list
    GAT path at zone counts where O(Z^2) is unaffordable.

    ``world_seed`` (default: ``seed``) seeds the ZONE WORLD separately
    from the agent draws — serving regenerates a training run's world
    (same world_seed) for a fresh agent population (different seed)."""
    rng = np.random.default_rng(seed)
    if world_seed is None:
        world_seed = seed

    edge_index = None
    if sparse_world:
        if num_zones is None:
            num_zones = len(ZONES)
        zf, edge_index = sparse_zone_world(num_zones, world_seed)
        adj = dist = None
    elif num_zones is None or num_zones == len(ZONES):
        zf = zone_feature_matrix()
        adj = adjacency_matrix()
        dist = distance_matrix()
    else:
        zf, adj, dist = synthetic_zone_world(num_zones, world_seed)
    Z = zf.shape[0]

    pop_w = zf[:, 0] + 1e-3  # log-population column
    job_w = zf[:, 1] + 1e-3
    home = rng.choice(Z, size=n_agents, p=pop_w / pop_w.sum())
    work = rng.choice(Z, size=n_agents, p=job_w / job_w.sum())

    t_leave = np.clip(rng.normal(8.5, 1.2, n_agents), 5.0, 12.0)
    t_return = np.clip(rng.normal(17.5, 1.5, n_agents), 13.0, 22.0)
    t_return = np.maximum(t_return, t_leave + 1.0)

    has_evening = rng.random(n_agents) < 0.35
    evening_zone = rng.choice(Z, size=n_agents)
    t_evening_end = np.clip(
        t_return + rng.uniform(0.5, 2.5, n_agents), t_return + 0.25, 23.5
    )

    times = np.linspace(0.0, 24.0, num_times).astype(np.float32)
    tt = times[None, :]
    at_work = (tt >= t_leave[:, None]) & (tt < t_return[:, None])
    at_evening = (
        has_evening[:, None]
        & (tt >= t_return[:, None])
        & (tt < t_evening_end[:, None])
    )
    zone_ids = np.where(
        at_work,
        work[:, None],
        np.where(at_evening, evening_zone[:, None], home[:, None]),
    ).astype(np.int32)

    person_feats = np.stack(
        [
            np.clip(rng.normal(40, 12, n_agents), 18, 75) / 100.0,
            np.clip(rng.normal(55e3, 25e3, n_agents), 1e4, 2e5) / 1e5,
            rng.random(n_agents),  # flexibility
            (rng.random(n_agents) < 0.7).astype(np.float64),  # fulltime
            (rng.random(n_agents) < 0.55).astype(np.float64),  # car
            home / max(Z - 1, 1),
            work / max(Z - 1, 1),
            np.ones(n_agents),
        ],
        axis=-1,
    ).astype(np.float32)

    out = {
        "times": times,
        "zone_ids": zone_ids,
        "person_feats": person_feats,
        "home_zone": home.astype(np.int32),
        "work_zone": work.astype(np.int32),
        "zone_features": zf,
        "adj": adj,
        "dist": dist,
    }
    if edge_index is not None:
        out["edge_index"] = edge_index
    return out


def synthetic_zone_world(num_zones: int, seed: int = 0):
    """Random spatial zone world at SA2-like scale (~500 zones): features
    (Z, 7), k-nearest-neighbour adjacency with self loops, distances."""
    rng = np.random.default_rng(seed + 1)
    coords = rng.uniform(0.0, 30.0, (num_zones, 2))
    pop = rng.lognormal(7.5, 1.0, num_zones)
    jobs = rng.lognormal(6.5, 1.5, num_zones)
    zf = np.stack(
        [
            np.log1p(pop) / 10.0,
            np.log1p(jobs) / 10.0,
            rng.random(num_zones),
            rng.random(num_zones),
            rng.random(num_zones),
            coords[:, 0] / 30.0,
            coords[:, 1] / 30.0,
        ],
        axis=-1,
    ).astype(np.float32)
    diff = coords[:, None, :] - coords[None, :, :]
    dist = np.sqrt((diff**2).sum(-1)).astype(np.float32)
    k = min(6, num_zones - 1)
    nn = np.argsort(dist, axis=1)[:, 1 : k + 1]
    adj = np.zeros((num_zones, num_zones), np.float32)
    rows = np.repeat(np.arange(num_zones), k)
    adj[rows, nn.ravel()] = 1.0
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 1.0)
    return zf, adj, dist


def _zone_features(coords, side, rng):
    """The 7-feature zone layout shared by the dense and sparse worlds
    (log-pop, log-jobs, 3 uniforms, normalized coords)."""
    num_zones = coords.shape[0]
    pop = rng.lognormal(7.5, 1.0, num_zones)
    jobs = rng.lognormal(6.5, 1.5, num_zones)
    return np.stack(
        [
            np.log1p(pop) / 10.0,
            np.log1p(jobs) / 10.0,
            rng.random(num_zones),
            rng.random(num_zones),
            rng.random(num_zones),
            coords[:, 0] / side,
            coords[:, 1] / side,
        ],
        axis=-1,
    ).astype(np.float32)


def sparse_zone_world(num_zones: int, seed: int = 0, k: int = 6):
    """Zone world as a COO edge list WITHOUT any (Z, Z) array — for
    zone counts where ``synthetic_zone_world``'s dense distance matrix
    and argsort (O(Z^2) memory, O(Z^2 log Z) time) are unaffordable.

    Approximate k-nearest-neighbour graph via grid bucketing: zones are
    hashed into square cells sized to the expected k-NN radius, each
    zone's candidate set is its 3x3 cell neighborhood (a fixed-width
    padded table, so the whole construction is vectorized numpy), and
    the k nearest candidates become edges. Symmetrized + self loops —
    the same graph family as ``synthetic_zone_world`` (which this
    matches exactly at small Z whenever no cell overflows the candidate
    table; overflow trims candidates, degrading gracefully to
    approximate k-NN). Zone density per unit area is held constant as
    Z grows (the map side scales with sqrt(Z)), matching the dense
    generator's local structure.

    Returns ``(zone_features (Z, 7) f32, (edge_src, edge_dst) int32)``
    with edges in the ``adj[i, j] != 0 <=> (src=j, dst=i)`` orientation
    of ``ops.segment.edges_from_adj``. Memory: O(Z * max_per_cell).
    """
    rng = np.random.default_rng(seed + 1)
    k = min(k, num_zones - 1)
    # constant density: ~500 zones on a 30x30 map, like the dense world
    side = 30.0 * max(1.0, np.sqrt(num_zones / 500.0))
    coords = rng.uniform(0.0, side, (num_zones, 2))
    zf = _zone_features(coords, side, rng)
    if num_zones <= 1 or k == 0:
        ids = np.arange(num_zones, dtype=np.int32)
        return zf, (ids, ids)

    # cell size ~2x the expected k-NN radius sqrt(k / (pi * density)):
    # the 3x3 neighborhood then almost surely contains the true k NN
    density = num_zones / (side * side)
    cell = 2.0 * np.sqrt(k / (np.pi * density))
    n_cells = max(1, int(np.floor(side / cell)))
    cell = side / n_cells
    cx = np.minimum((coords[:, 0] / cell).astype(np.int64), n_cells - 1)
    cy = np.minimum((coords[:, 1] / cell).astype(np.int64), n_cells - 1)
    cell_id = cx * n_cells + cy  # (Z,)

    # padded per-cell member table (vectorized bucket fill)
    order = np.argsort(cell_id, kind="stable")
    sorted_cells = cell_id[order]
    # rank of each zone within its cell
    starts = np.searchsorted(sorted_cells, np.arange(n_cells * n_cells))
    rank = np.arange(num_zones) - starts[sorted_cells]
    counts = np.bincount(cell_id, minlength=n_cells * n_cells)
    # cap the table at a generous width; overflow members are trimmed
    # from CANDIDATE sets only (they still get their own edges)
    max_per_cell = int(min(counts.max(), np.ceil(counts.mean() * 4 + 8)))
    table = np.full((n_cells * n_cells, max_per_cell), -1, np.int64)
    keep = rank < max_per_cell
    table[sorted_cells[keep], rank[keep]] = order[keep]

    # 3x3 neighborhood candidate gather: (Z, 9 * max_per_cell). Border
    # cells must NOT clip to in-range neighbors — that duplicates whole
    # cells, and duplicate candidate ids eat top-k slots (observed 80%
    # edge recall near borders). Out-of-range neighbors instead index a
    # dummy all-(-1) table row.
    offs = np.array([-1, 0, 1])
    nx = cx[:, None] + offs[None, :]  # (Z, 3)
    ny = cy[:, None] + offs[None, :]
    in_x = (nx >= 0) & (nx < n_cells)
    in_y = (ny >= 0) & (ny < n_cells)
    dummy = n_cells * n_cells
    ncells = np.where(
        in_x[:, :, None] & in_y[:, None, :],
        nx[:, :, None] * n_cells + ny[:, None, :],
        dummy,
    ).reshape(num_zones, 9)
    table_ext = np.vstack([table, np.full((1, max_per_cell), -1, np.int64)])
    cand = table_ext[ncells].reshape(num_zones, 9 * max_per_cell)
    valid = cand >= 0
    self_row = cand == np.arange(num_zones)[:, None]
    valid &= ~self_row
    d2 = np.where(
        valid,
        ((coords[cand.clip(0)] - coords[:, None, :]) ** 2).sum(-1),
        np.inf,
    )
    kk = min(k, d2.shape[1])
    nn_idx = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
    rows = np.repeat(np.arange(num_zones), kk)
    cols = cand[rows, nn_idx.ravel()]
    ok = np.isfinite(d2[rows, nn_idx.ravel()])
    rows, cols = rows[ok], cols[ok]

    # symmetrize + self loops, dedupe via linear codes
    i = np.concatenate([rows, cols, np.arange(num_zones)])
    j = np.concatenate([cols, rows, np.arange(num_zones)])
    codes = np.unique(i.astype(np.int64) * num_zones + j)
    dst = (codes // num_zones).astype(np.int32)  # receiving zone i
    src = (codes % num_zones).astype(np.int32)  # sending zone j
    return zf, (src, dst)
