"""The port's GJ-fed data pipeline against the reference's, bit for bit.

``repro_torch.data.JoinCorpus.build`` runs the port's
``GraphicalJoin(device="cpu").run()`` on a small Last.fm-like catalog;
``repro.data.JoinCorpus.build`` runs the reference's on the same
catalog (both packages' ``lastfm_like`` from the same seed).  Held
exactly: the join size, every ``materialize_range`` window, every
``TokenBatcher.next_batch`` (int32 tensors on the batcher's device)
across an epoch wrap, and ``state`` / ``load_state``.
"""

import numpy as np
import pytest
import torch

from repro.data.pipeline import JoinCorpus as RefCorpus
from repro.data.pipeline import TokenBatcher as RefBatcher
from repro.relational.synth import lastfm_like as ref_lastfm_like

from repro_torch.data import JoinCorpus, TokenBatcher
from repro_torch.relational.synth import lastfm_like

import torch_threads  # noqa: F401

LASTFM = dict(n_users=40, n_artists=30, artists_per_user=3,
              friends_per_user=2, seed=3)
VOCAB = 151_936


@pytest.fixture(scope="module")
def corpora():
    rcat, rqs = ref_lastfm_like(**LASTFM)
    cat, qs = lastfm_like(**LASTFM)
    ref = RefCorpus.build(rcat, rqs["lastfm_A1"], vocab=VOCAB)
    port = JoinCorpus.build(cat, qs["lastfm_A1"], vocab=VOCAB, device="cpu")
    assert port.num_rows == ref.num_rows > 1000
    return ref, port


@pytest.mark.parametrize("frac", [(0, 1), (0, 0.01), (0.3, 0.31),
                                  (0.999, 1.0), (0.5, 0.5)])
def test_materialize_range_matches_reference(corpora, frac):
    ref, port = corpora
    n = ref.num_rows
    lo, hi = int(frac[0] * n), int(frac[1] * n)
    want = ref.materialize_range(lo, hi)
    got = port.materialize_range(lo, hi)
    assert got.dtype == np.int32 and got.shape == (hi - lo, 16)
    np.testing.assert_array_equal(got, want)


def test_host_ranges_match_reference(corpora):
    ref, port = corpora
    for hosts in (1, 3, 7):
        spans = [port.host_range(h, hosts) for h in range(hosts)]
        assert spans == [ref.host_range(h, hosts) for h in range(hosts)]
        assert spans[0][0] == 0 and spans[-1][1] == port.num_rows


def test_feature_hash_shifts_logically(corpora):
    """Codes past 2^63 after the mix: a logical ``>> 33`` on uint64 keeps
    them non-negative, as an arithmetic int64 shift would not."""
    ref, port = corpora
    cols = {"A": np.asarray([0, 1, 2**40, 2**62], np.int64),
            "B": np.asarray([7, 2**50, 3, 5], np.int64)}
    got = port.rows_to_tokens(cols)
    np.testing.assert_array_equal(got, ref.rows_to_tokens(cols))
    assert (got >= 0).all() and (got < VOCAB).all()


@pytest.mark.parametrize("host,num_hosts", [(0, 1), (1, 3)])
def test_next_batch_matches_reference_through_an_epoch(corpora, host,
                                                       num_hosts):
    ref, port = corpora
    lo, hi = port.host_range(host, num_hosts)
    seq = 31
    batch = 4
    # enough batches to wrap the host's range at least once
    steps = 2 + (hi - lo) * 16 // (batch * (seq + 1))
    rb = RefBatcher(ref, batch, seq, host=host, num_hosts=num_hosts)
    pb = TokenBatcher(port, batch, seq, host=host, num_hosts=num_hosts,
                      device="cpu")
    for _ in range(steps):
        want = rb.next_batch()
        got = pb.next_batch()
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            assert got[key].device.type == "cpu"
            assert tuple(got[key].shape) == (batch, seq)
            np.testing.assert_array_equal(got[key].numpy(), want[key])
        assert pb.state() == rb.state()
    assert pb.epoch >= 1


def test_state_round_trip_resumes_bit_exactly(corpora):
    _, port = corpora
    a = TokenBatcher(port, 2, 63, device="cpu")
    for _ in range(3):
        a.next_batch()
    saved = a.state()
    expect = [a.next_batch() for _ in range(4)]
    b = TokenBatcher(port, 2, 63, device="cpu")
    b.load_state(saved)
    for want in expect:
        got = b.next_batch()
        assert torch.equal(got["tokens"], want["tokens"])
        assert torch.equal(got["labels"], want["labels"])
    assert b.state() == a.state()


def test_labels_are_tokens_shifted_by_one(corpora):
    _, port = corpora
    out = TokenBatcher(port, 3, 20, device="cpu").next_batch()
    flat = port.materialize_range(0, 4).reshape(-1)
    np.testing.assert_array_equal(out["tokens"].numpy()[0], flat[:20])
    np.testing.assert_array_equal(out["labels"].numpy()[0], flat[1:21])


@pytest.mark.parametrize("entry", ["corpus", "batcher"])
def test_cuda_without_a_card_raises(monkeypatch, corpora, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port = corpora
    cat, qs = lastfm_like(**LASTFM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "corpus":
            JoinCorpus.build(cat, qs["lastfm_A1"], vocab=VOCAB)
        else:
            TokenBatcher(port, 2, 8)
