"""The traffic generators: deterministic per seed, the stated distribution."""

import statistics

import numpy as np

from benchmark.harness import Cell

SEED = 2**31 + 12345


def _params():
    return Cell("cv3.datagen_b16").spec["params"]


def test_batch_offline_same_seed_same_inputs():
    from benchmark.traffic import batch_offline as t

    a, b = t.generate(_params(), SEED), t.generate(_params(), SEED)
    assert len(a["batches"]) == len(b["batches"])
    for x, y in zip(a["batches"], b["batches"]):
        assert all(np.array_equal(p, q) for p, q in zip(x, y))
    for k in ("instruct", "flow_tokens", "feat", "xvec"):
        assert np.array_equal(a["prompt"][k], b["prompt"][k])
    c = t.generate(_params(), SEED + 1)
    assert not np.array_equal(a["prompt"]["flow_tokens"], c["prompt"]["flow_tokens"])


def test_batch_offline_lengths_follow_the_stated_distribution():
    from benchmark.traffic import batch_offline as t

    p = _params()
    lengths = t.text_lengths(p)
    assert len(lengths) == p["batch"] * p["batches"]
    assert lengths.min() >= p["text_min"] and lengths.max() <= p["text_max"]
    assert abs(statistics.median(lengths) - p["text_median"]) <= 1
    # log-normal: the log-lengths' spread between the quartiles is 1.349 sigma (before clipping)
    q1, _, q3 = statistics.quantiles(np.log(lengths), n=4)
    assert abs((q3 - q1) / 1.349 - p["text_sigma"]) < 0.05


def test_batch_offline_every_seed_gets_the_same_sizes_sorted_into_batches():
    from benchmark.traffic import batch_offline as t

    p = _params()
    sizes = None
    for seed in (1, SEED, 2**31 + 7):
        inp = t.generate(p, seed)
        batches = inp["batches"]
        assert all(len(b) == p["batch"] for b in batches)
        got = sorted(tuple(len(x) for x in b) for b in batches)
        sizes = sizes or got
        assert got == sizes  # the same batches of lengths, in another order
        for b in batches:  # each batch holds neighbours of the length-sorted corpus
            assert [len(x) for x in b] == sorted(len(x) for x in b)
        assert all(x.max() < p["text_vocab"] for b in batches for x in b)
        assert inp["prompt"]["feat"].shape == (p["prompt_tokens"] * p["mel_ratio"], p["mel_bins"])


def test_batch_offline_order_alternates_short_and_long():
    from benchmark.traffic import batch_offline as t

    batches = t.generate(_params(), SEED)["batches"]
    longest = [max(len(x) for x in b) for b in batches]
    for i in range(0, len(longest) - 1, 2):  # every pair holds one batch of each half of the corpus
        pair = sorted(longest[i: i + 2])
        assert pair[0] <= statistics.median(longest) <= pair[1]
