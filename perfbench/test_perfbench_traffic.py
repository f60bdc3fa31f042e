"""The traffic generator: deterministic per seed, the same multiset of
lengths for every seed, the stated clips kept."""
import numpy as np

from perfbench import spec, traffic

CHAT = spec.load(spec.PERFBENCH / "traffic" / "chat.json")
# a mix of shared documents, as a document-QA cell would read it
DOCQA = {"name": "docqa", "loop": "closed", "requests_per_client": 64,
         "documents": {"count": 2, "tokens": 4096, "prefill_in_setup": True},
         "prompt_tokens": {"dist": "lognormal", "median": 128, "sigma": 0.8,
                           "min": 32, "max": 512},
         "output_tokens": {"dist": "lognormal", "median": 96, "sigma": 0.8,
                           "min": 16, "max": 384},
         "first_request": "residual"}
SEED = 2 ** 31 + 977


def _reqs(mix, seed, clients=4, per=5, vocab=1000):
    t = traffic.Traffic(mix, seed, clients, vocab)
    return [t.request(c, k) for c in range(clients) for k in range(per)]


def test_deterministic_per_seed():
    a, b = _reqs(CHAT, SEED), _reqs(CHAT, SEED)
    assert [(r.prompt, r.max_new) for r in a] == \
        [(r.prompt, r.max_new) for r in b]
    c = _reqs(CHAT, SEED + 1)
    assert [r.prompt for r in a] != [r.prompt for r in c]


def test_request_independent_of_order():
    t = traffic.Traffic(CHAT, SEED, 4, 1000)
    late = t.request(3, 2)
    t2 = traffic.Traffic(CHAT, SEED, 4, 1000)
    for c in range(4):
        t2.request(c, 0)
    assert t2.request(3, 2).prompt == late.prompt


def test_same_lengths_every_seed():
    """The seed draws token ids and documents, never a length."""
    for mix in (CHAT, DOCQA):
        a, b = (traffic.Traffic(mix, s, 32, 1000) for s in (1, SEED))
        assert a.prompt_len.tolist() == b.prompt_len.tolist()
        assert a.output_len.tolist() == b.output_len.tolist()
        assert a.residual.tolist() == b.residual.tolist()
        ra, rb = a.request(5, 1), b.request(5, 1)
        assert len(ra.prompt) == len(rb.prompt) and ra.prompt != rb.prompt
        # each round holds the stated quantiles, not one length repeated
        assert len(set(a.prompt_len[0].tolist())) > 16


def test_clips_and_median():
    for mix in (CHAT, DOCQA):
        for key in ("prompt_tokens", "output_tokens"):
            d = mix[key]
            v = traffic.lengths(d, 32 * mix["requests_per_client"])
            assert v.min() >= d["min"] and v.max() <= d["max"]
            assert abs(np.median(v) - d["median"]) <= 1
            assert v.min() == d["min"] and v.max() == d["max"]


def test_documents_and_residual_first():
    t = traffic.Traffic(DOCQA, SEED, 32, 1000)
    n_docs, n_tok = DOCQA["documents"]["count"], DOCQA["documents"]["tokens"]
    assert len(t.docs) == n_docs and all(len(d) == n_tok for d in t.docs)
    for c in range(32):
        r = t.request(c, 0)
        n_q = len(r.prompt) - r.prefix_len
        assert r.prompt[:r.prefix_len] == t.docs[r.doc]
        assert 32 <= n_q <= 512 and 16 <= r.max_new <= 384
    warm = t.warm_requests()
    assert [w.doc for w in warm] == list(range(n_docs))
    assert all(w.max_new == 1 for w in warm)
    first = [t.request(c, 0).max_new for c in range(32)]
    assert all(16 <= f <= 384 for f in first)
    assert sorted(first) == sorted(t.residual.tolist())
    assert first == [t.request(c, 0).max_new for c in range(32)]
