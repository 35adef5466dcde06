"""Caption scoring: CIDEr, a PTB-style tokenizer and METEOR; the port's copy
of ``aha_tpu/eval/captioning.py``.

* CIDEr: the COCO-caption scorer with its quirks (tf * (log N - log df)
  weights, counts clipped against the reference vector, the Gaussian length
  penalty at sigma 6, a "length" that counts bigrams).
* PTB tokenizer: a regex form of what the COCO pipeline takes from
  stanford-corenlp (lowercase, punctuation split off and dropped).
* METEOR: ``JavaMeteor`` drives meteor-1.5.jar over its stdio protocol where
  a JRE and the jar are found (``find_java_meteor``); else ``Meteor``, an
  exact + stem matcher with METEOR's alignment objective (alpha .9, beta 3,
  gamma .5) and no synonym or paraphrase tables, whose scores are not the
  jar's. ``build_meteor`` picks one (``AHA_METEOR=java|lite|auto``).
"""

from __future__ import annotations

import collections
import math
import os
import re

import numpy as np

# ---------------------------------------------------------------------------
# CIDEr
# ---------------------------------------------------------------------------


def _ngram_counts(sentence: str, n: int = 4) -> dict:
    words = sentence.split()
    counts: dict = collections.defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return counts


class CiderScorer:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma
        self.crefs: list[list[dict]] = []
        self.ctest: list[dict] = []

    def append(self, test: str, refs: list[str]):
        self.crefs.append([_ngram_counts(r, self.n) for r in refs])
        self.ctest.append(_ngram_counts(test, self.n))

    def compute_score(self) -> tuple[float, np.ndarray]:
        doc_freq: dict = collections.defaultdict(float)
        for refs in self.crefs:
            for ngram in set(ng for ref in refs for ng in ref):
                doc_freq[ngram] += 1
        ref_len = np.log(float(len(self.crefs)))

        def counts2vec(cnts):
            vec = [collections.defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ngram, tf in cnts.items():
                df = np.log(max(1.0, doc_freq[ngram]))
                k = len(ngram) - 1
                vec[k][ngram] = float(tf) * (ref_len - df)
                norm[k] += vec[k][ngram] ** 2
                if k == 1:  # ref quirk: "length" counts bigrams
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vh, vr, nh, nr, lh, lr):
            delta = float(lh - lr)
            val = np.zeros(self.n)
            for k in range(self.n):
                for ngram in vh[k]:
                    val[k] += min(vh[k][ngram], vr[k][ngram]) * vr[k][ngram]
                if nh[k] != 0 and nr[k] != 0:
                    val[k] /= nh[k] * nr[k]
                val[k] *= math.e ** (-(delta**2) / (2 * self.sigma**2))
            return val

        scores = []
        for test, refs in zip(self.ctest, self.crefs):
            vec, norm, length = counts2vec(test)
            score = np.zeros(self.n)
            for ref in refs:
                vr, nr, lr = counts2vec(ref)
                score += sim(vec, vr, norm, nr, length, lr)
            scores.append(float(np.mean(score) / len(refs) * 10.0))
        arr = np.asarray(scores)
        return float(arr.mean()) if len(arr) else 0.0, arr


class Cider:
    """The COCO scorer's compute_score(gts, res): dicts of {key: [sentence]}
    (res one hypothesis, gts several references)."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: dict, res: dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        scorer = CiderScorer(self.n, self.sigma)
        for key in sorted(gts.keys()):
            hypo, refs = res[key], gts[key]
            assert isinstance(hypo, list) and len(hypo) == 1 and refs
            scorer.append(hypo[0], refs)
        return scorer.compute_score()


# ---------------------------------------------------------------------------
# PTB-style tokenizer
# ---------------------------------------------------------------------------

_PTB_PUNCT = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}


def ptb_tokenize_sentence(text: str) -> str:
    """Lowercase, split words/punctuation, drop PTB punctuation tokens."""
    text = text.replace("\n", " ")
    tokens = re.findall(r"[\w]+(?:'[\w]+)?|[^\w\s]", text.lower())
    kept = []
    for t in tokens:
        if t in ("%", "$"):
            kept.append(t)
        elif t in _PTB_PUNCT or re.fullmatch(r"[^\w\s]", t):
            continue
        else:
            kept.append(t)
    return " ".join(kept)


class PTBTokenizer:
    """COCO-surface tokenizer: {key: [{'caption': str}, ...]} ->
    {key: [tokenized_str, ...]}."""

    def tokenize(self, captions_for_image: dict) -> dict:
        return {
            k: [ptb_tokenize_sentence(c["caption"]) for c in v]
            for k, v in captions_for_image.items()
        }


# ---------------------------------------------------------------------------
# METEOR-lite
# ---------------------------------------------------------------------------


def _porter_light(word: str) -> str:
    """Very small suffix stemmer (enough for matching inflections)."""
    for suf in ("ingly", "edly", "ings", "ing", "ies", "ied", "es", "ed", "s"):
        if word.endswith(suf) and len(word) - len(suf) >= 3:
            return word[: -len(suf)]
    return word


def _align(hyp: list[str], ref: list[str]) -> tuple[int, int]:
    """Greedy two-stage alignment (exact, then stem), chunk-minimizing.
    Returns (matches, chunks)."""
    ref_free = [True] * len(ref)
    align: list[tuple[int, int]] = []
    for stage in ("exact", "stem"):
        key = (lambda w: w) if stage == "exact" else _porter_light
        ref_keys = [key(w) for w in ref]
        for i, hw in enumerate(hyp):
            if any(a[0] == i for a in align):
                continue
            hk = key(hw)
            candidates = [j for j in range(len(ref)) if ref_free[j] and ref_keys[j] == hk]
            if not candidates:
                continue
            # prefer the candidate that continues the previous chunk
            prev = next((a[1] for a in align if a[0] == i - 1), None)
            j = next((c for c in candidates if prev is not None and c == prev + 1),
                     candidates[0])
            align.append((i, j))
            ref_free[j] = False
    align.sort()
    matches = len(align)
    chunks = 0
    for idx, (i, j) in enumerate(align):
        if idx == 0 or align[idx - 1][0] != i - 1 or align[idx - 1][1] != j - 1:
            chunks += 1
    return matches, chunks


def meteor_sentence(hyp: str, refs: list[str], alpha=0.9, beta=3.0, gamma=0.5) -> float:
    """Classic METEOR scoring formula (alpha=.9, beta=3, gamma=.5 — the
    parameterization NLTK ships), best over references."""
    best = 0.0
    h = hyp.split()
    for ref in refs:
        r = ref.split()
        m, chunks = _align(h, r)
        if m == 0 or not h or not r:
            continue
        p = m / len(h)
        rc = m / len(r)
        f = p * rc / (alpha * p + (1 - alpha) * rc)
        frag = chunks / m
        score = f * (1 - gamma * frag**beta)
        best = max(best, score)
    return best


class Meteor:
    """METEOR-lite with the Java wrapper's compute_score(gts, res) surface."""

    backend = "lite"

    def compute_score(self, gts: dict, res: dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        scores = []
        for key in sorted(gts.keys()):
            scores.append(meteor_sentence(res[key][0], gts[key]))
        arr = np.asarray(scores)
        return float(arr.mean()) if len(arr) else 0.0, arr


# ---------------------------------------------------------------------------
# Java METEOR backend (optional): meteor-1.5.jar over the reference wrapper's
# stdio protocol, the jar's own numbers wherever a JRE and the jar exist;
# METEOR-lite otherwise.
# ---------------------------------------------------------------------------


def find_java_meteor():
    """(java_bin, jar_path) when a JRE and meteor-1.5.jar are reachable,
    else None. Jar: $AHA_METEOR_JAR or conventional locations; JRE:
    $JRE_BIN_JAVA or PATH."""
    import shutil

    jar = os.environ.get("AHA_METEOR_JAR")
    if not jar:
        for cand in (
            "metrics/meteor-1.5.jar",
            os.path.join(os.path.dirname(__file__), "meteor-1.5.jar"),
        ):
            if os.path.exists(cand):
                jar = cand
                break
    java = os.environ.get("JRE_BIN_JAVA") or shutil.which("java")
    if jar and os.path.exists(jar) and java:
        return java, jar
    return None


class JavaMeteor:
    """Persistent meteor-1.5.jar subprocess: one 'SCORE ||| ref1 ||| ... |||
    hyp' line per segment (each answered with a stat line), then one 'EVAL
    ||| stats...' line answered with per-segment scores followed by the
    aggregate. ``popen`` stands in a process object (tests)."""

    backend = "java"

    def __init__(self, java_bin: str | None = None, jar: str | None = None,
                 *, popen=None):
        import subprocess
        import threading

        if popen is not None:
            self.p = popen
        else:
            cmd = [java_bin, "-jar", "-Xmx2G", jar, "-", "-", "-stdio",
                   "-l", "en", "-norm"]
            self.p = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                      stdout=subprocess.PIPE)
        self.lock = threading.Lock()

    def compute_score(self, gts: dict, res: dict):
        with self.lock:
            assert sorted(gts.keys()) == sorted(res.keys())
            ids = sorted(gts.keys())
            stats = []
            for i in ids:
                assert len(res[i]) == 1
                hyp = res[i][0].replace("|||", "").replace("  ", " ")
                line = " ||| ".join(("SCORE", " ||| ".join(gts[i]), hyp))
                self.p.stdin.write((line + "\n").encode())
                self.p.stdin.flush()
                stats.append(self.p.stdout.readline().decode().strip())
            self.p.stdin.write(
                ("EVAL ||| " + " ||| ".join(stats) + "\n").encode())
            self.p.stdin.flush()
            scores = [float(self.p.stdout.readline().decode()) for _ in ids]
            final = float(self.p.stdout.readline().decode())
        return final, np.asarray(scores)


def build_meteor():
    """METEOR backend factory. ``AHA_METEOR=java`` requires the jar
    (raises if absent); ``=lite`` forces METEOR-lite; default ``auto``
    uses the jar when a JRE + jar are present, METEOR-lite otherwise."""
    mode = os.environ.get("AHA_METEOR", "auto").lower()
    if mode == "lite":
        return Meteor()
    found = find_java_meteor()
    if found is not None:
        return JavaMeteor(*found)
    if mode == "java":
        raise RuntimeError(
            "AHA_METEOR=java but no JRE + meteor-1.5.jar found "
            "(set AHA_METEOR_JAR and/or JRE_BIN_JAVA)")
    return Meteor()
