"""Caption metrics: BLEU-1..4, CIDEr, ROUGE-L, METEOR, as
``spacap3d_tpu/eval/capeval.py``.

Host-side (pure Python/numpy) implementations of the COCO-caption scoring
algorithms, matching the reference's vendored scorers
(lib/capeval/{bleu,cider,rouge,meteor}) decision-for-decision:

  * BLEU: per-corpus brevity penalty with the 'closest' effective
    reference length, clipped n-gram counts against per-ref max counts,
    tiny/small smoothing constants (bleu/bleu_scorer.py:197-258).
  * CIDEr: n=1..4 tf-idf cosine with idf document count = number of
    keys (images), log ref-len = log(#images), per-ref gaussian length
    penalty sigma=6. Quirk preserved: the "length" used by the penalty
    counts *bigrams* (the reference increments length only when the
    ngram index n==1, cider/cider_scorer.py:140-141).
  * ROUGE-L: LCS F-beta with beta=1.2, max precision/recall over refs
    (rouge/rouge.py:36-102).
  * METEOR: the reference shells out to the METEOR-1.5 java jar
    (meteor/meteor.py:12-58). ``Meteor`` does the same when a jar is
    available (``SPACAP_METEOR_JAR`` or the default path); otherwise it
    falls back to a pure-Python exact+stem matcher (``MeteorLite``) and
    flags itself as non-parity via ``Meteor.is_exact``.

API: each scorer has ``compute_score(gts, res) -> (score, per_key_scores)``
where gts/res map key -> list of sentence strings (res lists have 1 entry).
"""
from __future__ import annotations

import math
import os
import subprocess
import threading
from collections import Counter, defaultdict
from typing import Dict, List

import numpy as np


def _ngrams(words: List[str], n: int) -> Counter:
    counts: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


# -----------------------------------------------------------------------------
# BLEU
# -----------------------------------------------------------------------------

class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        n = self.n
        small, tiny = 1e-9, 1e-15

        total_guess = [0] * n
        total_correct = [0] * n
        total_testlen = 0
        total_reflen = 0.0
        per_sentence: List[List[float]] = [[] for _ in range(n)]

        for key in gts.keys():
            hyp_words = res[key][0].split()
            testlen = len(hyp_words)
            ref_counts: Dict = {}
            reflens = []
            for ref in gts[key]:
                ref_words = ref.split()
                reflens.append(len(ref_words))
                for ng, c in _ngrams(ref_words, n).items():
                    ref_counts[ng] = max(ref_counts.get(ng, 0), c)
            # 'closest' effective reference length (ties -> shorter)
            reflen = min((abs(l - testlen), l) for l in reflens)[1]

            guess = [max(0, testlen - k) for k in range(n)]
            correct = [0] * n
            for ng, c in _ngrams(hyp_words, n).items():
                correct[len(ng) - 1] += min(ref_counts.get(ng, 0), c)

            total_testlen += testlen
            total_reflen += reflen
            bleu = 1.0
            ratio = (testlen + tiny) / (reflen + small)
            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]
                bleu *= (correct[k] + tiny) / (guess[k] + small)
                val = bleu ** (1.0 / (k + 1))
                if ratio < 1:
                    val *= math.exp(1 - 1 / ratio)
                per_sentence[k].append(val)

        bleus = []
        bleu = 1.0
        ratio = (total_testlen + tiny) / (total_reflen + small)
        for k in range(n):
            bleu *= (total_correct[k] + tiny) / (total_guess[k] + small)
            val = bleu ** (1.0 / (k + 1))
            if ratio < 1:
                val *= math.exp(1 - 1 / ratio)
            bleus.append(val)
        return bleus, per_sentence

    def method(self):
        return "Bleu"


# -----------------------------------------------------------------------------
# CIDEr
# -----------------------------------------------------------------------------

def _cider_counts2vec(cnts: Counter, df: Dict, ref_len: float, n: int):
    vec = [defaultdict(float) for _ in range(n)]
    norm = [0.0] * n
    length = 0
    for ng, tf in cnts.items():
        idf = ref_len - np.log(max(1.0, df[ng]))
        k = len(ng) - 1
        vec[k][ng] = float(tf) * idf
        norm[k] += vec[k][ng] ** 2
        if k == 1:          # quirk: "length" counts bigrams
            length += tf
    return vec, [math.sqrt(x) for x in norm], length


class CiderRefs:
    """Seed-invariant reference-side CIDEr state for a fixed corpus:
    per-key reference ngram counts, document frequencies, and per-ref
    TF-IDF vectors/norms/lengths. The 100-seed mul_eval grid scores the
    SAME corpus once per seed; precomputing these once and passing
    ``Cider(refs=...)`` reuses identical intermediate values (identical
    expressions on identical inputs, so the scores are bit-equal) and
    removes most of the per-seed CIDEr cost."""

    def __init__(self, gts: Dict, n: int = 4):
        self.n = n
        self.keys = list(gts.keys())
        self.crefs = [[_ngrams(r.split(), n) for r in gts[k]]
                      for k in self.keys]
        df: Dict = defaultdict(float)
        for refs in self.crefs:
            for ng in set(ng for ref in refs for ng in ref):
                df[ng] += 1.0
        self.df = df
        self.ref_len = np.log(float(len(self.crefs)))
        self.ref_vecs = [
            [_cider_counts2vec(ref, df, self.ref_len, n) for ref in refs]
            for refs in self.crefs
        ]


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0,
                 refs: "CiderRefs | None" = None):
        self.n = n
        self.sigma = sigma
        self.refs = refs

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        keys = list(gts.keys())
        n, sigma = self.n, self.sigma

        if self.refs is not None and self.refs.n == n \
                and self.refs.keys == keys:
            crefs, df, ref_len = self.refs.crefs, self.refs.df, self.refs.ref_len
            ref_vecs = self.refs.ref_vecs
        else:
            crefs = [[_ngrams(r.split(), n) for r in gts[k]] for k in keys]
            # document frequency over reference sets
            df = defaultdict(float)
            for refs in crefs:
                for ng in set(ng for ref in refs for ng in ref):
                    df[ng] += 1.0
            ref_len = np.log(float(len(crefs)))
            ref_vecs = [
                [_cider_counts2vec(ref, df, ref_len, n) for ref in refs]
                for refs in crefs
            ]

        ctests = [_ngrams(res[k][0].split(), n) for k in keys]
        scores = []
        for test, rvecs, refs in zip(ctests, ref_vecs, crefs):
            vec, norm, length = _cider_counts2vec(test, df, ref_len, n)
            score = np.zeros(n)
            for vref, nref, lref in rvecs:
                delta = float(length - lref)
                val = np.zeros(n)
                for k in range(n):
                    for ng in vec[k]:
                        # .get (not defaultdict access): identical value,
                        # but never inserts zeros into the shared cached
                        # reference vectors
                        rv = vref[k].get(ng, 0.0)
                        val[k] += min(vec[k][ng], rv) * rv
                    if norm[k] != 0 and nref[k] != 0:
                        val[k] /= norm[k] * nref[k]
                    val[k] *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                score += val
            scores.append(float(score.mean() / len(refs) * 10.0))
        return float(np.mean(scores)), np.array(scores)

    def method(self):
        return "CIDEr"


# -----------------------------------------------------------------------------
# ROUGE-L
# -----------------------------------------------------------------------------

def _lcs_len(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[len(b)]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        hyp = candidate[0].split(" ")
        precs, recs = [], []
        for ref in refs:
            r = ref.split(" ")
            lcs = _lcs_len(r, hyp)
            precs.append(lcs / float(len(hyp)))
            recs.append(lcs / float(len(r)))
        pmax, rmax = max(precs), max(recs)
        if pmax != 0 and rmax != 0:
            b2 = self.beta ** 2
            return ((1 + b2) * pmax * rmax) / float(rmax + b2 * pmax)
        return 0.0

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        scores = [self.calc_score(res[k], gts[k]) for k in gts.keys()]
        return float(np.mean(scores)), np.array(scores)

    def method(self):
        return "Rouge"


# -----------------------------------------------------------------------------
# METEOR
# -----------------------------------------------------------------------------

DEFAULT_METEOR_JAR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "meteor-1.5.jar"
)


class MeteorJar:
    """stdio wrapper around the METEOR-1.5 jar (bit-for-bit parity path;
    same protocol as reference lib/capeval/meteor/meteor.py:12-58).

    ``command`` overrides the subprocess argv (used by the protocol test
    to exercise the exact stdio path against a scripted fake jar)."""

    def __init__(self, jar_path: str, command=None):
        self.lock = threading.Lock()
        cmd = command or [
            "java", "-jar", "-Xmx2G", jar_path, "-", "-", "-stdio", "-l",
            "en", "-norm",
        ]
        self.proc = subprocess.Popen(
            cmd,
            cwd=os.path.dirname(os.path.abspath(jar_path)) if command is None
            else None,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            universal_newlines=True, bufsize=1,
        )

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        keys = list(gts.keys())
        with self.lock:
            eval_line = "EVAL"
            for k in keys:
                hyp = res[k][0].replace("|||", "").replace("  ", " ")
                score_line = " ||| ".join(
                    ("SCORE", " ||| ".join(gts[k]), hyp)
                )
                self.proc.stdin.write(score_line + "\n")
                eval_line += " ||| " + self.proc.stdout.readline().strip()
            self.proc.stdin.write(eval_line + "\n")
            scores = [float(self.proc.stdout.readline().strip()) for _ in keys]
            final = float(self.proc.stdout.readline().strip())
        return final, np.array(scores)

    def close(self):
        """Terminate the jar process (reference meteor.py __del__)."""
        with self.lock:
            if self.proc.poll() is None:
                try:
                    self.proc.stdin.close()
                except (BrokenPipeError, OSError):
                    pass
                self.proc.kill()
                self.proc.wait()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_VOWELS = "aeiou"


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: the number of VC sequences in the stem."""
    forms = "".join("C" if _is_cons(stem, i) else "V" for i in range(len(stem)))
    m = 0
    prev = None
    for c in forms:
        if prev == "V" and c == "C":
            m += 1
        prev = c
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1)


def _cvc(w: str) -> bool:
    if len(w) < 3:
        return False
    return (_is_cons(w, len(w) - 3) and not _is_cons(w, len(w) - 2)
            and _is_cons(w, len(w) - 1) and w[-1] not in "wxy")


def porter_stem(w: str) -> str:
    """The classic Porter (1980) stemming algorithm — the stemmer METEOR's
    'stem' matcher module uses (via Snowball's english/porter)."""
    if len(w) <= 2:
        return w
    w = w.lower()

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]

    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"

    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"), ("alli", "al"),
        ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
        ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
        ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
        ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break

    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
                "ous", "ive", "ize"):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and (not stem or stem[-1] not in "st"):
                    break
                w = stem
            break

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


_STEM_CACHE: Dict[str, str] = {}


def _stem_cached(w: str) -> str:
    s = _STEM_CACHE.get(w)
    if s is None:
        s = porter_stem(w)
        _STEM_CACHE[w] = s
    return s


# English closed-class (function) words for METEOR's delta weighting. The
# jar ships a corpus-derived resources/function.words list (not
# redistributable); this is the standard closed-class inventory —
# articles, prepositions, conjunctions, pronouns, auxiliaries, plus the
# pipeline's sos/eos sentinels (which the jar's -norm run also treats as
# high-frequency tokens).
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both either
neither of in on at by for with about against between into through
during before after above below to from up down out off over under
again further and but or nor so yet as if then than because while
although though since until unless whereas i me my mine myself we us
our ours ourselves you your yours yourself yourselves he him his
himself she her hers herself it its itself they them their theirs
themselves who whom whose which what where when why how be am is are
was were been being have has had having do does did doing will would
shall should can could may might must not only very too also just
there here sos eos
""".split())


def locate_wordnet_dir() -> "str | None":
    """A WordNet 3.x dictionary directory (the ``index.noun``/``index.verb``
    /... files), if one is locatable: ``SPACAP_WORDNET_DIR`` first, then
    the conventional nltk_data locations. None otherwise — the synonym
    stage is strictly opt-in-by-availability."""
    cands = []
    env = os.environ.get("SPACAP_WORDNET_DIR")
    if env is not None:
        # explicit empty/'none'/'0' DISABLES the synonym stage entirely
        # (no nltk_data fallback), so that processes on hosts with
        # differing nltk_data can score under one METEOR definition
        if not env or env.lower() in ("0", "none", "disabled"):
            return None
        cands.append(env)
    nltk_roots = os.environ.get("NLTK_DATA", "").split(os.pathsep)
    nltk_roots += [os.path.expanduser("~/nltk_data"), "/usr/share/nltk_data",
                   "/usr/local/share/nltk_data"]
    for root in nltk_roots:
        if root:
            cands.append(os.path.join(root, "corpora", "wordnet"))
    for c in cands:
        if c and os.path.exists(os.path.join(c, "index.noun")):
            return c
    return None


_WN_CACHE: Dict[str, Dict[str, frozenset]] = {}


def load_wordnet_synsets(wn_dir: str) -> Dict[str, frozenset]:
    """lemma -> set of '<pos-letter><synset-offset>' ids, parsed straight
    from the WordNet index.* files (no nltk dependency). Two words are
    METEOR-synonymous iff their id sets intersect — the same
    share-a-synset test the jar's synonymy module applies (its synonym
    dictionary is flattened from WordNet 3.0)."""
    if wn_dir in _WN_CACHE:
        return _WN_CACHE[wn_dir]
    syn: Dict[str, set] = {}
    # WordNet's own synset-type letters: n/v/a/r (adverb is 'r', NOT
    # 'a' — 'a' is adjective; using pos[0] for both would conflate the
    # two offset namespaces and fabricate adjective<->adverb synonym
    # matches wherever their data-file offsets collide)
    for pos, letter in (("noun", "n"), ("verb", "v"),
                        ("adj", "a"), ("adv", "r")):
        path = os.path.join(wn_dir, f"index.{pos}")
        if not os.path.exists(path):
            continue
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith("  ") or not line.strip():
                    continue  # license header lines are indented
                parts = line.split()
                # index line: lemma pos synset_cnt p_cnt [ptrs...]
                #             sense_cnt tagsense_cnt offset...
                if len(parts) < 6:
                    continue
                try:
                    synset_cnt = int(parts[2])
                except ValueError:
                    continue
                if synset_cnt <= 0:
                    continue  # -0: would slice the WHOLE line as offsets
                offsets = parts[-synset_cnt:]
                # offsets are 8-digit decimals; skip corrupt lines rather
                # than admit pointer symbols ('@', '1', ...) as fake
                # shared synset ids that make unrelated words "synonyms"
                if not all(o.isdigit() for o in offsets):
                    continue
                ids = {letter + o for o in offsets}
                syn.setdefault(parts[0], set()).update(ids)
    out = {w: frozenset(s) for w, s in syn.items()}
    _WN_CACHE[wn_dir] = out
    return out


class MeteorLite:
    """Pure-Python METEOR-1.5 scorer (Denkowski & Lavie 2014) with the
    exact and Porter-stem matcher stages:

      * alignment: beam search over hypothesis positions (beam 40, like
        the jar's Aligner resolve stage) selecting the one-to-one match
        set that maximizes matches, then minimizes chunks, then
        maximizes matcher weight;
      * matcher weights w_exact=1.0, w_stem=0.6 and content/function
        word weighting delta (English 0.75): each match contributes
        w * delta for a content word and w * (1-delta) for a function
        word, on each side independently;
      * P = wsum_hyp / (delta*|h_content| + (1-delta)*|h_function|),
        R likewise over the reference; Fmean = P*R/(alpha*P+(1-alpha)*R);
        Pen = gamma * (chunks/matches)^beta; score = Fmean * (1-Pen);
        best reference wins.

    English-task parameters alpha=.85 beta=.2 gamma=.6 delta=.75.

    Synonym stage (METEOR-1.5's third matcher module, weight 0.8): active
    when a WordNet dictionary is locatable (``SPACAP_WORDNET_DIR`` or an
    nltk_data dir — ``locate_wordnet_dir``); two words match if their
    synset-id sets intersect. Stage PRECEDENCE follows the jar's module
    order — a pair also matched by exact/stem takes that earlier stage's
    weight even though w_stem(0.6) < w_syn(0.8).

    NON-PARITY fallback versus the jar regardless (no paraphrase table —
    it cannot be shipped; closed-class function-word list instead of the
    jar's corpus-derived one) — use the jar for published numbers. The
    2005 METEOR configuration (Banerjee & Lavie: Fmean=10PR/(R+9P),
    Pen=0.5*(ch/m)^3, exact-weight stems, no delta) is reproducible via
    constructor args."""

    def __init__(self, alpha: float = 0.85, beta: float = 0.2,
                 gamma: float = 0.6, delta: float = 0.75,
                 w_exact: float = 1.0, w_stem: float = 0.6,
                 beam: int = 40,
                 w_syn: float = 0.8, wordnet_dir: "str | None" = None):
        self.alpha, self.beta, self.gamma, self.delta = alpha, beta, gamma, delta
        self.w_exact, self.w_stem, self.w_syn = w_exact, w_stem, w_syn
        self.beam = beam
        wn = wordnet_dir if wordnet_dir is not None else locate_wordnet_dir()
        self.synsets: Dict[str, frozenset] = (
            load_wordnet_synsets(wn) if wn else {})
        self.has_synonyms = bool(self.synsets)

    def _align(self, hyp: List[str], ref: List[str]):
        """Returns (n_match, n_chunk, wsum_hyp, wsum_ref) of the best
        one-to-one alignment by (matches desc, chunks asc, weight desc)."""
        d = self.delta
        # candidate matches per hyp position: (j, weight). Stage order =
        # jar module order: exact, stem, synonym (first stage to match a
        # pair sets its weight)
        ref_stems = [_stem_cached(w) for w in ref]
        syn = self.synsets
        empty = frozenset()
        ref_syns = [syn.get(w, empty) for w in ref] if syn else None
        cands = []
        for hw in hyp:
            row = []
            hs = _stem_cached(hw)
            hsyn = syn.get(hw, empty) if syn else empty
            for j, rw in enumerate(ref):
                if hw == rw:
                    row.append((j, self.w_exact))
                elif hs == ref_stems[j]:
                    row.append((j, self.w_stem))
                elif hsyn and not hsyn.isdisjoint(ref_syns[j]):
                    row.append((j, self.w_syn))
            cands.append(row)
        hw_f = [w in FUNCTION_WORDS for w in hyp]
        rw_f = [w in FUNCTION_WORDS for w in ref]

        # beam over hyp positions; state keyed by (used_mask, prev_j)
        # where prev_j = ref index matched at the PREVIOUS hyp position
        # (-1 if it was unmatched) for incremental chunk counting.
        # value = (n_match, -n_chunk, wsum_h + wsum_r, wsum_h, wsum_r)
        states = {(0, -1): (0, 0, 0.0, 0.0, 0.0)}
        for i, row in enumerate(cands):
            new: Dict = {}

            def upd(key, val):
                old = new.get(key)
                if old is None or val[:3] > old[:3]:
                    new[key] = val

            for (mask, _pj), val in states.items():
                upd((mask, -1), val)    # hyp word i unmatched
            for (mask, pj), (nm, nc, _ws, wh, wr) in states.items():
                for j, w in row:
                    if mask & (1 << j):
                        continue
                    chunk = nc if j == pj + 1 and pj >= 0 else nc - 1
                    nwh = wh + w * (d if not hw_f[i] else 1 - d)
                    nwr = wr + w * (d if not rw_f[j] else 1 - d)
                    upd((mask | (1 << j), j),
                        (nm + 1, chunk, nwh + nwr, nwh, nwr))
            if len(new) > self.beam:
                top = sorted(new.items(), key=lambda kv: kv[1][:3],
                             reverse=True)[: self.beam]
                new = dict(top)
            states = new
        nm, nc, _ws, wh, wr = max(states.values(), key=lambda v: v[:3])
        return nm, -nc, wh, wr

    def sentence_score(self, hyp_s: str, refs: List[str]) -> float:
        hyp = hyp_s.lower().split()
        d = self.delta
        best = 0.0
        if not hyp:
            return 0.0
        denom_h = sum(1 - d if f else d
                      for f in (w in FUNCTION_WORDS for w in hyp))
        for ref_s in refs:
            ref = ref_s.lower().split()
            if not ref:
                continue
            m, chunks, wh, wr = self._align(hyp, ref)
            if m == 0:
                continue
            denom_r = sum(1 - d if f else d
                          for f in (w in FUNCTION_WORDS for w in ref))
            p = wh / denom_h
            r = wr / denom_r
            if p == 0 or r == 0:
                continue
            fmean = p * r / (self.alpha * p + (1 - self.alpha) * r)
            pen = self.gamma * (chunks / m) ** self.beta
            best = max(best, fmean * (1 - pen))
        return best

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        scores = [self.sentence_score(res[k][0], gts[k]) for k in gts.keys()]
        return float(np.mean(scores)), np.array(scores)


class Meteor:
    """Dispatches to the jar when present, MeteorLite otherwise.

    ``SPACAP_METEOR_COMMAND`` (shlex-split) overrides the subprocess argv
    — used by tests to route the one-persistent-process contract through
    the scripted fake jar without java. A jar process is expensive (JVM
    spawn + model load), so hold ONE ``Meteor`` per evaluation run and
    share it across seeds, exactly like the reference's single persistent
    process (lib/capeval/meteor/meteor.py:12-26); ``close()`` when done.
    ``wordnet_dir`` goes to ``MeteorLite``: None locates a dictionary, ""
    turns its synonym stage off."""

    def __init__(self, jar_path: str | None = None, wordnet_dir: str | None = None):
        jar = jar_path or os.environ.get("SPACAP_METEOR_JAR", DEFAULT_METEOR_JAR)
        cmd_env = os.environ.get("SPACAP_METEOR_COMMAND")
        if cmd_env:
            import shlex
            self.is_exact = True
            self._impl = MeteorJar(jar, command=shlex.split(cmd_env))
        else:
            self.is_exact = os.path.exists(jar)
            self._impl = (MeteorJar(jar) if self.is_exact
                          else MeteorLite(wordnet_dir=wordnet_dir))

    def compute_score(self, gts: Dict, res: Dict):
        return self._impl.compute_score(gts, res)

    def close(self):
        if isinstance(self._impl, MeteorJar):
            self._impl.close()

    def method(self):
        return "METEOR"
