"""The port's caption metrics against the JAX package's on the same
corpora: BLEU-1..4, CIDEr (fresh and with the seed-invariant reference
cache), ROUGE-L, MeteorLite (with and without a WordNet synonym stage),
the Porter stemmer and the METEOR jar protocol. Both sides run the same
host arithmetic, so scores are compared with ``==``."""
import os
import sys

import numpy as np
import pytest

from spacap3d_tpu.eval import capeval as jax_capeval
from spacap3d_tpu_torch.eval import capeval

FAKE_JAR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fake_meteor_jar.py")
WORDS = ["a", "red", "chair", "by", "the", "wall", "big", "tables", "running", "runs",
         "sofa", "couch", "sos", "eos"]


def random_corpus(seed, keys=40):
    rng = np.random.RandomState(seed)

    def sent(k):
        return "sos " + " ".join(rng.choice(WORDS, k)) + " eos"

    gts = {f"s|{i}|obj": [sent(rng.randint(3, 12)) for _ in range(rng.randint(1, 4))]
           for i in range(keys)}
    res = {k: [sent(rng.randint(0, 12))] for k in gts}
    return gts, res


CORPORA = {
    # the reference scorers' __main__ demos (tests/test_capeval.py)
    "bleu_demo": ({"0": ["sos good eos", "sos jll good good good good eos"],
                   "1": ["sos good eos", "sos jll good good good good eos"]},
                  {"0": ["sos eos"], "1": ["sos eos"]}),
    "rouge_demo": ({"0": ["sos jll good good good good  jll good good good good  "
                          "jll good good good good eos"]}, {"0": ["sos eos"]}),
    "cider_unigram": ({"0": ["a b"], "1": ["a c"]}, {"0": ["a b"], "1": ["c"]}),
    "perfect": ({str(i): [f"a b c d e unique{i}"] for i in range(4)},
                {str(i): [f"a b c d e unique{i}"] for i in range(4)}),
    "disjoint": ({"0": ["a b c"], "1": ["d e f"]}, {"0": ["x y z"], "1": ["u v w"]}),
    "random_0": random_corpus(0),
    "random_1": random_corpus(1, keys=120),
}


def both(name, *args, **kw):
    return getattr(capeval, name)(*args, **kw), getattr(jax_capeval, name)(*args, **kw)


def assert_same_score(got, want):
    assert got[0] == want[0]
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("metric", ["Bleu", "Cider", "Rouge", "MeteorLite"])
def test_metric_equals_jax(corpus, metric):
    gts, res = CORPORA[corpus]
    port, ref = both(metric)
    assert_same_score(port.compute_score(gts, res), ref.compute_score(gts, res))


@pytest.mark.parametrize("corpus", ["random_0", "random_1"])
def test_cider_reference_cache_equals_jax(corpus):
    gts, res = CORPORA[corpus]
    port = capeval.Cider(refs=capeval.CiderRefs(gts))
    ref = jax_capeval.Cider(refs=jax_capeval.CiderRefs(gts))
    for trial in range(2):      # the cache is reused, never mutated
        assert_same_score(port.compute_score(gts, res), ref.compute_score(gts, res))
        assert_same_score(port.compute_score(gts, res), capeval.Cider().compute_score(gts, res))
        res = {k: [v[0].replace("red", "big")] for k, v in res.items()}


def test_porter_stem_equals_jax():
    words = sorted({w for gts, res in CORPORA.values() for s in [*res.values(), *gts.values()]
                    for sent in s for w in sent.split()})
    words += ["caresses", "ponies", "agreed", "motoring", "conflated", "hopping",
              "replacement", "adoption", "angulariti", "bowdlerize", "controll", "generalization"]
    assert [capeval.porter_stem(w) for w in words] == [jax_capeval.porter_stem(w) for w in words]


def test_meteor_lite_synonym_stage_equals_jax(tmp_path):
    wn = tmp_path / "wordnet"
    wn.mkdir()
    (wn / "index.noun").write_text(
        "  1 a license header line\n"
        "sofa n 1 1 @ 1 0 04256520\n"
        "couch n 2 1 @ 2 0 04256520 00001234\n"
        "chair n 1 1 @ 1 0 03001627\n")
    (wn / "index.verb").write_text("runs v 1 1 @ 1 0 01926311\nrun v 1 1 @ 1 0 01926311\n")
    port, ref = both("MeteorLite", wordnet_dir=str(wn))
    assert port.has_synonyms and ref.has_synonyms
    gts, res = CORPORA["random_1"]
    assert_same_score(port.compute_score(gts, res), ref.compute_score(gts, res))
    assert port.compute_score({"k": ["the couch"]}, {"k": ["the sofa"]})[0] > \
        capeval.MeteorLite(wordnet_dir="").compute_score({"k": ["the couch"]},
                                                         {"k": ["the sofa"]})[0]


def test_meteor_dispatch_and_jar_protocol_equal_jax(tmp_path, monkeypatch):
    port, ref = both("Meteor", str(tmp_path / "missing.jar"))
    assert port.is_exact is False and ref.is_exact is False
    assert isinstance(port._impl, capeval.MeteorLite)
    monkeypatch.setenv("SPACAP_METEOR_COMMAND", f"{sys.executable} {FAKE_JAR}")
    port, ref = both("Meteor")
    try:
        assert port.is_exact is True
        gts, res = CORPORA["random_0"]
        res = {k: [v[0] + " ||| x"] for k, v in res.items()}   # the separator is scrubbed
        assert_same_score(port.compute_score(gts, res), ref.compute_score(gts, res))
    finally:
        port.close()
        ref.close()
    assert port._impl.proc.poll() is not None
