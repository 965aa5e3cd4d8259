"""HetRec 2011 Last.fm-2k at its published scale, after ``lastfm_like``
(``repro_torch/relational/synth.py``), with the artists drawn distinct.

``user_artists`` has the published number of rows: every user distinct
artists (49 or 50 at the published scale), drawn one after another without
replacement under Zipf(alpha) weights, as the dataset lists each user's top
artists; ``user_friends`` gives every user
``friends_per_user`` Zipf(alpha / 2) draws over the users, self-pairs
dropped, made symmetric and de-duplicated.  The draws come from
``data_seed``, so every run seed joins the same structure and does the
same work: the run seed relabels users and artists by seeded permutations
and shuffles the rows of both tables.
"""

from __future__ import annotations

import numpy as np

from gjbench.data import Data


def zipf_codes(rng: np.random.Generator, n: int, domain: int,
               alpha: float) -> np.ndarray:
    """n samples in [0, domain) with Zipf-ish skew (alpha=0 => uniform)."""
    if alpha <= 0.0:
        return rng.integers(0, domain, size=n, dtype=np.int64)
    ranks = np.arange(1, domain + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    return rng.choice(domain, size=n, p=p).astype(np.int64)


def zipf_distinct(rng: np.random.Generator, per_row: np.ndarray,
                  domain: int, alpha: float, block: int = 256) -> np.ndarray:
    """``per_row[i]`` distinct codes in [0, domain) for each row i, drawn
    one after another without replacement under Zipf(alpha) weights: the
    largest log-weights plus Gumbel noise, in order.  Rows concatenated."""
    logp = -alpha * np.log(np.arange(1, domain + 1, dtype=np.float64))
    k = int(per_row.max())
    out = np.empty((len(per_row), k), np.int64)
    for i in range(0, len(per_row), block):
        key = logp - np.log(-np.log(rng.random((min(block, len(per_row) - i),
                                                domain))))
        top = np.argpartition(-key, k - 1, axis=1)[:, :k]
        order = np.argsort(-np.take_along_axis(key, top, axis=1), axis=1)
        out[i:i + block] = np.take_along_axis(top, order, axis=1)
    return out[np.arange(k) < per_row[:, None]]


def base_tables(n_users: int, n_artists: int, user_artists: int,
                friends_per_user: int, alpha: float, data_seed: int):
    """(user_artists [n, 2], user_friends [m, 2]) in base ids: every user
    ``user_artists // n_users`` distinct artists, and one more for
    ``user_artists % n_users`` users drawn from the seed."""
    rng = np.random.default_rng(data_seed)
    per_user = np.full(n_users, user_artists // n_users, np.int64)
    per_user[rng.choice(n_users, user_artists % n_users, replace=False)] += 1
    ua_u = np.repeat(np.arange(n_users, dtype=np.int64), per_user)
    ua_a = zipf_distinct(rng, per_user, n_artists, alpha)
    ua = np.stack([ua_u, ua_a], axis=1)
    uf_u = np.repeat(np.arange(n_users, dtype=np.int64), friends_per_user)
    uf_f = zipf_codes(rng, len(uf_u), n_users, alpha / 2)
    keep = uf_u != uf_f
    pairs = np.stack([uf_u[keep], uf_f[keep]], axis=1)
    uf = np.unique(np.concatenate([pairs, pairs[:, ::-1]], axis=0), axis=0)
    return ua, uf


def generate(sizes: dict, data_seed: int, seed: int) -> Data:
    ua, uf = base_tables(sizes["n_users"], sizes["n_artists"],
                         sizes["user_artists"], sizes["friends_per_user"],
                         sizes["alpha"], data_seed)
    rng = np.random.default_rng(seed)
    user = rng.permutation(sizes["n_users"]).astype(np.int64)
    artist = rng.permutation(sizes["n_artists"]).astype(np.int64)
    ua = ua[rng.permutation(len(ua))]
    uf = uf[rng.permutation(len(uf))]
    tables = {
        "user_artists": {"userID": user[ua[:, 0]],
                         "artistID": artist[ua[:, 1]]},
        "user_friends": {"userID": user[uf[:, 0]],
                         "friendID": user[uf[:, 1]]},
    }
    return Data(tables)
