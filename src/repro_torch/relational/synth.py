"""Synthetic datasets shaped like the paper's workloads.

The paper evaluates on JOB (many-to-many, high result redundancy), lastFM
(friend chains: high UIR), TPCH SF1 (FK joins: no UIR, low redundancy), and
a cyclic lastFM query.  Those datasets are not available offline, so each
generator here reproduces the *structural* properties the paper credits for
its results (UIR fraction, result redundancy, skew, cyclicity) with
controllable scale knobs.  Exact join sizes are printed by the benchmark
harness next to each run.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.relational.query import JoinQuery
from repro_torch.relational.table import Catalog, Table


# ---------------------------------------------------------------------------
# Paper running example (Figure 1) — used heavily by unit tests.
# ---------------------------------------------------------------------------

def figure1() -> Tuple[Catalog, JoinQuery]:
    """The exact 3-table chain join of the paper's Figure 1."""
    t1 = Table(
        "table1",
        {
            "A": ["a0", "a0", "a0", "a1", "a1", "a2", "a3", "a3", "a3", "a3", "a3", "a3"],
            "B": ["b0", "b0", "b0", "b1", "b1", "b1", "b3", "b3", "b4", "b4", "b4", "b4"],
        },
    )
    t2 = Table(
        "table2",
        {
            "B": ["b0", "b0", "b1", "b1", "b1", "b2", "b2", "b2", "b3", "b4", "b4", "b4"],
            "C": ["c0", "c0", "c0", "c0", "c0", "c1", "c1", "c1", "c2", "c3", "c3", "c4"],
        },
    )
    t3 = Table(
        "table3",
        {
            "C": ["c1", "c1", "c1", "c1", "c2", "c2", "c2", "c2", "c3", "c3", "c4", "c4"],
            "D": ["d0", "d0", "d0", "d0", "d2", "d2", "d2", "d2", "d3", "d3", "d4", "d4"],
        },
    )
    query = JoinQuery.of(
        "figure1",
        [
            ("table1", {"A": "A", "B": "B"}),
            ("table2", {"B": "B", "C": "C"}),
            ("table3", {"C": "C", "D": "D"}),
        ],
    )
    return Catalog.of(t1, t2, t3), query


# ---------------------------------------------------------------------------
# Generic generators
# ---------------------------------------------------------------------------

def _zipf_codes(rng: np.random.Generator, n: int, domain: int, alpha: float) -> np.ndarray:
    """n samples in [0, domain) with Zipf-ish skew (alpha=0 => uniform)."""
    if alpha <= 0.0:
        return rng.integers(0, domain, size=n, dtype=np.int64)
    ranks = np.arange(1, domain + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    return rng.choice(domain, size=n, p=p).astype(np.int64)


def chain_join(
    n_tables: int = 3,
    rows: int = 10_000,
    domain: int = 1_000,
    *,
    alpha: float = 1.1,
    drop_frac: float = 0.3,
    seed: int = 0,
    name: str = "chain",
) -> Tuple[Catalog, JoinQuery]:
    """A chain T1(V0,V1) ⋈ T2(V1,V2) ⋈ ... with many-to-many join keys.

    ``alpha`` controls value skew (redundancy in the result), ``drop_frac``
    removes a random fraction of each table's join-key domain so that
    neighbouring tables only partially overlap (this manufactures UIR:
    intermediate tuples that die later in the chain).
    """
    rng = np.random.default_rng(seed)
    cat = Catalog()
    tables = []
    for i in range(n_tables):
        lo = _zipf_codes(rng, rows, domain, alpha)
        hi = _zipf_codes(rng, rows, domain, alpha)
        if drop_frac > 0.0:
            keep_lo = rng.random(domain) >= drop_frac
            keep_hi = rng.random(domain) >= drop_frac
            mask = keep_lo[lo] & keep_hi[hi]
            lo, hi = lo[mask], hi[mask]
        t = Table(f"{name}_t{i}", {f"V{i}": lo, f"V{i+1}": hi})
        cat.add(t)
        tables.append((t.name, {f"V{i}": f"V{i}", f"V{i+1}": f"V{i+1}"}))
    return cat, JoinQuery.of(name, tables)


# ---------------------------------------------------------------------------
# Adversarially skewed cyclic patterns (triangle / clique / star-cyclic).
#
# The hub-and-spoke construction is the classic AGM lower-bound family:
# every edge table is half out-of-hub rows (a_i, 0) and half into-hub rows
# (0, b_j), so each PAIRWISE join goes quadratic through the hub while the
# cyclic output stays near-linear — exactly the gap between pure-GJ
# elimination (pairwise products) and a WCOJ bag step (per-level
# intersection, bounded by the AGM bound).  A small dense uniform slice is
# mixed in so the output is non-empty.  ``hub_frac`` is the skew knob:
# 1.0 is the full adversarial instance, 0.0 degrades to uniform edges
# (where pure GJ and the hybrid plan cost about the same).
# ---------------------------------------------------------------------------

_CYCLIC_PATTERNS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "triangle": (("A", "B"), ("B", "C"), ("C", "A")),
    "clique4": (("A", "B"), ("A", "C"), ("A", "D"),
                ("B", "C"), ("B", "D"), ("C", "D")),
    # wheel W3: star hub M over a triangle rim — star + cycle in one query
    "star_cyclic": (("M", "A"), ("M", "B"), ("M", "C"),
                    ("A", "B"), ("B", "C"), ("C", "A")),
}


def cyclic_pattern_like(
    pattern: str = "triangle",
    m: int = 1_500,
    domain: int = 5_000,
    *,
    hub_frac: float = 1.0,
    dense: int = 200,
    dense_domain: int = 40,
    seed: int = 0,
) -> Tuple[Catalog, JoinQuery]:
    """One edge table per pattern edge, hub-skewed (see module section above).

    ``pattern``: "triangle", "clique4", or "star_cyclic".  Each edge table
    has ``2 * m * hub_frac`` hub rows, ``2 * m * (1 - hub_frac)`` uniform
    rows, and ``dense`` rows uniform over the small shared ``dense_domain``
    (the slice the cyclic output actually comes from).
    """
    if pattern not in _CYCLIC_PATTERNS:
        raise ValueError(f"unknown cyclic pattern {pattern!r} "
                         f"(have {sorted(_CYCLIC_PATTERNS)})")
    if not 0.0 <= hub_frac <= 1.0:
        raise ValueError("hub_frac must be in [0, 1]")
    rng = np.random.default_rng(seed)
    n_hub = int(m * hub_frac)
    n_unif = m - n_hub
    cat = Catalog()
    tables = []
    for u, v in _CYCLIC_PATTERNS[pattern]:
        x = np.concatenate([
            rng.integers(1, domain, n_hub),          # (a_i, 0) out of hub
            np.zeros(n_hub, np.int64),               # (0, b_j) into hub
            rng.integers(1, dense_domain, dense),    # dense slice
            rng.integers(1, domain, 2 * n_unif),     # uniform remainder
        ])
        y = np.concatenate([
            np.zeros(n_hub, np.int64),
            rng.integers(1, domain, n_hub),
            rng.integers(1, dense_domain, dense),
            rng.integers(1, domain, 2 * n_unif),
        ])
        t = Table(f"{pattern}_{u}{v}", {"x": x, "y": y})
        cat.add(t)
        tables.append((t.name, {"x": u, "y": v}))
    return cat, JoinQuery.of(f"{pattern}_hub", tables)


# ---------------------------------------------------------------------------
# lastFM-like: users/friends/artists.  High UIR, chain + cyclic queries.
# ---------------------------------------------------------------------------

def lastfm_like(
    n_users: int = 2_000,
    n_artists: int = 2_000,
    artists_per_user: int = 25,
    friends_per_user: int = 6,
    *,
    alpha: float = 1.05,
    seed: int = 0,
) -> Tuple[Catalog, Dict[str, JoinQuery]]:
    """user_artists(u, a) and user_friends(u, f) with skewed popularity."""
    rng = np.random.default_rng(seed)

    ua_u = np.repeat(np.arange(n_users, dtype=np.int64), artists_per_user)
    ua_a = _zipf_codes(rng, len(ua_u), n_artists, alpha)
    ua = np.unique(np.stack([ua_u, ua_a], axis=1), axis=0)
    user_artists = Table("user_artists", {"userID": ua[:, 0], "artistID": ua[:, 1]})

    uf_u = np.repeat(np.arange(n_users, dtype=np.int64), friends_per_user)
    uf_f = _zipf_codes(rng, len(uf_u), n_users, alpha / 2)
    keep = uf_u != uf_f
    pairs = np.stack([uf_u[keep], uf_f[keep]], axis=1)
    sym = np.concatenate([pairs, pairs[:, ::-1]], axis=0)  # friendship is symmetric
    sym = np.unique(sym, axis=0)
    user_friends = Table("user_friends", {"userID": sym[:, 0], "friendID": sym[:, 1]})

    cat = Catalog.of(user_artists, user_friends)

    queries = {
        # users' friends' artists:  A1 - U1 - U2 - A2 chain (self-join of ua)
        "lastfm_A1": JoinQuery.of(
            "lastfm_A1",
            [
                ("user_artists", {"artistID": "A1", "userID": "U1"}),
                ("user_friends", {"userID": "U1", "friendID": "U2"}),
                ("user_artists", {"userID": "U2", "artistID": "A2"}),
            ],
        ),
        # friends-of-friends' artists: one more hop => more UIR
        "lastfm_A2": JoinQuery.of(
            "lastfm_A2",
            [
                ("user_artists", {"artistID": "A1", "userID": "U1"}),
                ("user_friends", {"userID": "U1", "friendID": "U2"}),
                ("user_friends", {"userID": "U2", "friendID": "U3"}),
                ("user_artists", {"userID": "U3", "artistID": "A2"}),
            ],
        ),
        # longer chain standing in for the paper's lastFM_B (largest result)
        "lastfm_B": JoinQuery.of(
            "lastfm_B",
            [
                ("user_artists", {"artistID": "A1", "userID": "U1"}),
                ("user_friends", {"userID": "U1", "friendID": "U2"}),
                ("user_artists", {"userID": "U2", "artistID": "A2"}),
                ("user_friends", {"userID": "U2", "friendID": "U3"}),
            ],
        ),
        # cyclic: 4-cycle of friendships + an artist shared by U1 and U4.
        # Same junction-tree shape as the paper's lastFM_cyc (Figure 6).
        "lastfm_cyc": JoinQuery.of(
            "lastfm_cyc",
            [
                ("user_friends", {"userID": "U1", "friendID": "U2"}),
                ("user_friends", {"userID": "U2", "friendID": "U3"}),
                ("user_friends", {"userID": "U3", "friendID": "U4"}),
                ("user_friends", {"userID": "U4", "friendID": "U1"}),
                ("user_artists", {"userID": "U1", "artistID": "Ar"}),
                ("user_artists", {"userID": "U4", "artistID": "Ar"}),
            ],
        ),
        # pure triangle (classic WCOJ stress shape)
        "lastfm_tri": JoinQuery.of(
            "lastfm_tri",
            [
                ("user_friends", {"userID": "U1", "friendID": "U2"}),
                ("user_friends", {"userID": "U2", "friendID": "U3"}),
                ("user_friends", {"userID": "U3", "friendID": "U1"}),
            ],
        ),
    }
    return cat, queries


# ---------------------------------------------------------------------------
# JOB-like: star joins on a movie key with skewed fan-outs (many-to-many,
# high result redundancy).
# ---------------------------------------------------------------------------

def job_like(
    n_movies: int = 5_000,
    keywords_per_movie: int = 8,
    companies_per_movie: int = 3,
    cast_per_movie: int = 12,
    *,
    alpha: float = 1.2,
    seed: int = 0,
) -> Tuple[Catalog, Dict[str, JoinQuery]]:
    rng = np.random.default_rng(seed)

    def fan_table(name: str, key: str, val: str, per: int, vocab: int) -> Table:
        m = _zipf_codes(rng, n_movies * per, n_movies, alpha)
        v = _zipf_codes(rng, n_movies * per, vocab, alpha / 2)
        # real JOB m:n tables repeat pairs (same person, several roles);
        # duplicate rows are what gives the flat join result its run-length
        # redundancy (paper §1.1, Figure 2)
        mult = 1 + _zipf_codes(rng, len(m), 4, 1.2)
        m, v = np.repeat(m, mult), np.repeat(v, mult)
        return Table(name, {key: m, val: v})

    title = Table(
        "title",
        {"id": np.arange(n_movies, dtype=np.int64),
         "kind_id": rng.integers(0, 7, n_movies).astype(np.int64)},
    )
    movie_keyword = fan_table("movie_keyword", "movie_id", "keyword_id",
                              keywords_per_movie, n_movies * 2)
    movie_companies = fan_table("movie_companies", "movie_id", "company_id",
                                companies_per_movie, n_movies // 4)
    cast_info = fan_table("cast_info", "movie_id", "person_id",
                          cast_per_movie, n_movies * 3)

    cat = Catalog.of(title, movie_keyword, movie_companies, cast_info)
    queries = {
        "job_A": JoinQuery.of(
            "job_A",
            [
                ("title", {"id": "M", "kind_id": "K"}),
                ("movie_keyword", {"movie_id": "M", "keyword_id": "KW"}),
                ("movie_companies", {"movie_id": "M", "company_id": "CO"}),
            ],
        ),
        "job_B": JoinQuery.of(
            "job_B",
            [
                ("title", {"id": "M", "kind_id": "K"}),
                ("movie_keyword", {"movie_id": "M", "keyword_id": "KW"}),
                ("movie_companies", {"movie_id": "M", "company_id": "CO"}),
                ("cast_info", {"movie_id": "M", "person_id": "P"}),
            ],
        ),
        "job_C": JoinQuery.of(
            "job_C",
            [
                ("movie_keyword", {"movie_id": "M", "keyword_id": "KW"}),
                ("cast_info", {"movie_id": "M", "person_id": "P"}),
            ],
        ),
        "job_D": JoinQuery.of(  # the blow-up query (two high-fanout edges + star)
            "job_D",
            [
                ("movie_keyword", {"movie_id": "M", "keyword_id": "KW"}),
                ("cast_info", {"movie_id": "M", "person_id": "P"}),
                ("movie_companies", {"movie_id": "M", "company_id": "CO"}),
            ],
        ),
    }
    return cat, queries


# ---------------------------------------------------------------------------
# TPCH-like FK joins: no UIR, tiny result redundancy — GJ's worst case.
# ---------------------------------------------------------------------------

def tpch_fk_like(
    n_customers: int = 10_000,
    orders_per_customer: int = 10,
    n_nations: int = 25,
    *,
    seed: int = 0,
) -> Tuple[Catalog, Dict[str, JoinQuery]]:
    rng = np.random.default_rng(seed)
    customer = Table(
        "customer",
        {"c_custkey": np.arange(n_customers, dtype=np.int64),
         "c_nationkey": rng.integers(0, n_nations, n_customers).astype(np.int64)},
    )
    n_orders = n_customers * orders_per_customer
    orders = Table(
        "orders",
        {"o_orderkey": np.arange(n_orders, dtype=np.int64),
         "o_custkey": rng.integers(0, n_customers, n_orders).astype(np.int64)},
    )
    nation = Table(
        "nation",
        {"n_nationkey": np.arange(n_nations, dtype=np.int64),
         "n_regionkey": rng.integers(0, 5, n_nations).astype(np.int64)},
    )
    lineitem = Table(
        "lineitem",
        {"l_orderkey": rng.integers(0, n_orders, n_orders * 4).astype(np.int64),
         "l_partkey": rng.integers(0, n_customers, n_orders * 4).astype(np.int64)},
    )
    cat = Catalog.of(customer, orders, nation, lineitem)
    queries = {
        "fk_A": JoinQuery.of(
            "fk_A",
            [
                ("orders", {"o_orderkey": "O", "o_custkey": "C"}),
                ("customer", {"c_custkey": "C", "c_nationkey": "N"}),
                ("nation", {"n_nationkey": "N", "n_regionkey": "R"}),
            ],
        ),
        "fk_B": JoinQuery.of(
            "fk_B",
            [
                ("lineitem", {"l_orderkey": "O", "l_partkey": "P"}),
                ("orders", {"o_orderkey": "O", "o_custkey": "C"}),
                ("customer", {"c_custkey": "C", "c_nationkey": "N"}),
            ],
        ),
    }
    return cat, queries


def duplicate_rows(cat: Catalog, factor: int = 2) -> Catalog:
    """Replicate every tuple `factor`x (the paper's *_dup redundancy knob)."""
    out = Catalog()
    for name, t in cat.tables.items():
        idx = np.repeat(np.arange(t.num_rows), factor)
        out.add(Table(name, {c: v[idx] for c, v in t.columns.items()}))
    return out
