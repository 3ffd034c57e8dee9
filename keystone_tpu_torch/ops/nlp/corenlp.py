"""Lemmatized, entity-normalized n-gram extraction.

Port of ``keystone_tpu/ops/nlp/corenlp.py``, with its own copies of the
irregular-form table, suffix rules and gazetteer. The reference
(nodes/nlp/CoreNLPFeatureExtractor.scala:18-45) drives the CoreNLP
wrapper (sista FastNLPProcessor) to tokenize → lemmatize → replace named
entities with their type → emit per-sentence n-grams. This is a
self-contained re-implementation of the same contract, with no JVM:

- sentences split on terminal punctuation;
- tokens lemmatized by an English rule lemmatizer (irregular-form table +
  ordered suffix rules, the morphy-style algorithm);
- proper nouns are replaced by their entity TYPE — a gazetteer resolves
  the frequent-name head ("John" → PERSON, "Florida" → LOCATION, the
  reference suite's own committed expectations); other mid-sentence
  capitalized tokens get the generic ``"ENTITY"`` tag;
- n-grams of the requested orders are emitted per sentence, joined by
  spaces, sentence boundaries respected.

Agreement with the committed morpha-behavior gold
(tests/fixtures/corenlp_lemma_gold.json) is measured by the tests; the
port's lemmas equal the JAX package's on every gold word.
"""

from __future__ import annotations

import re
from typing import List, Sequence

from ...workflow.pipeline import Transformer

# Irregular forms (the exceptions list every rule lemmatizer carries).
# Coverage target measured against tests/fixtures/corenlp_lemma_gold.json
# (curated morpha/CoreNLP-behavior gold — see test_nlp.py provenance note).
_IRREGULAR = {
    "is": "be", "are": "be", "was": "be", "were": "be", "been": "be",
    "am": "be", "being": "be", "has": "have", "had": "have", "does": "do",
    "did": "do", "done": "do", "goes": "go", "went": "go", "gone": "go",
    "said": "say", "says": "say", "made": "make", "took": "take",
    "taken": "take", "came": "come", "saw": "see", "seen": "see",
    "got": "get", "gotten": "get", "gave": "give", "given": "give",
    "knew": "know", "known": "know", "thought": "think", "found": "find",
    "told": "tell", "became": "become", "left": "leave", "felt": "feel",
    "brought": "bring", "held": "hold", "wrote": "write", "written": "write",
    "stood": "stand", "lost": "lose", "paid": "pay", "met": "meet",
    "ran": "run", "kept": "keep",
    "ate": "eat", "eaten": "eat", "bought": "buy", "broke": "break",
    "broken": "break", "built": "build", "caught": "catch",
    "chose": "choose", "chosen": "choose", "drove": "drive",
    "driven": "drive", "fell": "fall", "fallen": "fall", "grew": "grow",
    "grown": "grow", "heard": "hear", "led": "lead", "meant": "mean",
    "sat": "sit", "sent": "send", "sold": "sell", "spent": "spend",
    "spoke": "speak", "spoken": "speak", "taught": "teach",
    "understood": "understand", "won": "win", "died": "die", "dying": "die",
    "lying": "lie", "tying": "tie", "used": "use", "using": "use",
    "children": "child", "men": "man",
    "women": "woman", "people": "person", "feet": "foot", "teeth": "tooth",
    "mice": "mouse", "geese": "goose", "better": "good", "best": "good",
    "worse": "bad", "worst": "bad",
    # -ves plurals are lexical, not structural ("gives"/"moves" end the
    # same way and must NOT become *gif/*mof)
    "knives": "knife", "wives": "wife", "wolves": "wolf",
    "shelves": "shelf", "halves": "half", "leaves": "leaf",
    "loaves": "loaf", "calves": "calf", "thieves": "thief",
    "buses": "bus", "shoes": "shoe",
}

# Words a lemmatizer must leave alone even though they wear inflection
# clothing (-s nouns that are singular, -ing nouns/prepositions, -ed
# adjectives/numbers). morpha resolves these by dictionary + POS; a rule
# lemmatizer needs the explicit list.
_NO_STRIP = frozenset({
    "news", "series", "species", "perhaps", "always", "yes", "gas",
    "its", "his", "hers", "ours", "yours", "theirs", "as",
    "during", "morning", "evening", "nothing", "something", "everything",
    "anything", "thing", "king", "ring", "string", "spring", "wing",
    "hundred", "indeed", "sacred", "speed", "feed", "breed", "seed",
    "naked", "wicked", "red", "bed", "need",
})

# Stems (post -ing/-ed strip) whose base form ends in silent 'e' but
# whose final letter doesn't signal it structurally (v/c/z/u/s do; these
# don't): "mak(ing)" → "make". Applied only when no consonant undoubling
# happened, so "hopping" → hop while "hoping" → hope.
_E_RESTORE = frozenset({
    "mak", "tak", "lik", "com", "becom", "writ", "hop", "chang", "manag",
    "includ", "provid", "decid", "creat", "unit", "smil", "stat", "not",
    "quot", "vot", "invit", "excit", "relat", "oper", "gener", "compar",
    "prepar", "shar", "declar", "requir", "acquir", "admir", "retir",
    "inspir", "estim", "imagin", "determin", "combin", "defin", "examin",
    "machin", "nam", "tim", "car", "stor", "scor", "ignor", "explor",
    "wast", "tast", "hat", "dat", "rat", "fil", "rul", "styl", "saf",
    "caus",  # ends -us so the "focus" guard blocks the -se rule
})

# Ordered inflectional suffix rules (first match wins):
# (suffix, replacement, min stem). Derivational suffixes (-er/-est/-ly)
# are NOT stripped — a lemmatizer maps inflections only, and stripping
# them mangles common words ("other", "really").
_SUFFIX_RULES = [
    ("sses", "ss", 1), ("xes", "x", 1), ("ches", "ch", 1), ("shes", "sh", 1),
    ("ies", "y", 2), ("ied", "y", 2), ("ying", "y", 2), ("oes", "o", 1),
    ("ing", "", 3), ("tted", "t", 2), ("ed", "", 3), ("es", "e", 2),
    ("s", "", 3),
]

# Words ending in these are not plural-stripped ("this", "thus", "bus",
# "glass" — already handled by sses — "analysis"). -ics nouns (physics,
# mathematics) are singular too.
_S_PROTECT = ("ss", "us", "is", "ics")

_SENTENCE_SPLIT = re.compile(r"(?<=[.!?])\s+")
_TOKEN = re.compile(r"[A-Za-z0-9']+")
# Quirk preserved from the reference: '+' sits inside the character class
# (literal plus survives normalization), reference:
# CoreNLPFeatureExtractor.scala:42 uses the identical pattern.
_NORMALIZE = re.compile(r"[^a-zA-Z0-9\s+]")

ENTITY_TAG = "ENTITY"

# Gazetteer NER stand-in: the reference substitutes CoreNLP's entity TYPE
# for the token ("John" → PERSON, "Florida" → LOCATION —
# CoreNLPFeatureExtractor.scala:9-33 and its suite's committed
# expectations). Without a statistical NER this covers the frequent-name
# head of the distribution and falls back to the generic ENTITY tag for
# other proper nouns.
_PERSON_NAMES = frozenset("""
john james robert michael william david richard joseph thomas charles
mary patricia jennifer linda elizabeth barbara susan jessica sarah karen
christopher daniel matthew anthony mark donald steven paul andrew joshua
kenneth kevin brian george edward ronald timothy jason jeffrey ryan
nancy lisa betty margaret sandra ashley kimberly emily donna michelle
peter henry frank samuel walter arthur albert eugene lawrence roger
anna emma olivia sophia isabella mia charlotte amelia harper evelyn
""".split())

_LOCATIONS = frozenset("""
florida california texas york alaska hawaii arizona nevada oregon ohio
georgia virginia michigan illinois boston chicago seattle houston dallas
denver atlanta miami philadelphia phoenix detroit baltimore portland
america england france germany spain italy china japan india russia
brazil canada mexico australia egypt kenya nigeria sweden norway poland
london paris berlin madrid rome moscow tokyo beijing delhi cairo sydney
europe asia africa antarctica washington
""".split())

# Gazetteer entries that are ALSO common English words ("Mark the boxes
# carefully", "Frank discussion", "China plate"): sentence-initial
# capitalization alone must not entity-tag these — mid-sentence
# capitalization still does.
_AMBIGUOUS_INITIAL = frozenset({
    "mark", "frank", "bill", "grace", "rose", "china", "georgia",
})


def lemmatize(word: str) -> str:
    """Rule lemmatization of a lowercase word."""
    if word in _IRREGULAR:
        return _IRREGULAR[word]
    if word in _NO_STRIP:
        return word
    for suffix, repl, min_stem in _SUFFIX_RULES:
        if suffix == "s" and word.endswith(_S_PROTECT):
            continue
        if word.endswith(suffix) and len(word) - len(suffix) >= min_stem:
            stem = word[: -len(suffix)] + repl
            if repl == "":  # bare -ing/-ed/-s strip: fix up the stem
                # doubling un-done: "running" -> "runn" -> "run"; when it
                # fires, the base never had a silent e, so skip restore
                if len(stem) >= 3 and stem[-1] == stem[-2] and stem[-1] not in "aeiouls":
                    return stem[:-1]
                if suffix in ("ing", "ed"):
                    # silent-e restoration: structural signals first
                    # (English bases end -ve/-ce/-ze/-ue: "believ(e)",
                    # "danc(e)", "amaz(e)", "argu(e)"), then -se bases
                    # ("los(e)", "caus(e)" — but not -ss/-us stems:
                    # "miss", "focus"), -ee bases ("agre(e)"), and the
                    # lexical _E_RESTORE list for the rest ("mak(e)").
                    if stem[-1] in "vczu":
                        return stem + "e"
                    if stem[-1] == "e":
                        return stem if stem.endswith("ee") else stem + "e"
                    if stem[-1] == "s" and not stem.endswith(("ss", "us")):
                        return stem + "e"
                    if stem in _E_RESTORE:
                        return stem + "e"
            return stem
    return word


class CoreNLPFeatureExtractor(Transformer):
    """str → list of lemmatized / entity-normalized n-gram strings
    (reference: nodes/nlp/CoreNLPFeatureExtractor.scala:18-45)."""

    def __init__(self, orders: Sequence[int]):
        self.orders = list(orders)

    def apply(self, text: str) -> List[str]:
        sentences = []
        for sent in _SENTENCE_SPLIT.split(text):
            raw_tokens = _TOKEN.findall(sent)
            tokens = []
            for i, tok in enumerate(raw_tokens):
                cap = tok[:1].isupper() and tok[1:].islower()
                low = tok.lower()
                known = (low in _PERSON_NAMES or low in _LOCATIONS) and (
                    i > 0 or low not in _AMBIGUOUS_INITIAL
                )
                if cap and (i > 0 or known):
                    # Entity-type substitution (reference contract): the
                    # gazetteer names its type; other capitalized tokens
                    # (mid-sentence only — sentence-initial capitals are
                    # usually ordinary words) get the generic tag.
                    if low in _PERSON_NAMES:
                        tokens.append("PERSON")
                    elif low in _LOCATIONS:
                        tokens.append("LOCATION")
                    else:
                        tokens.append(ENTITY_TAG)
                else:
                    norm = _NORMALIZE.sub("", tok).lower()
                    if norm:
                        tokens.append(lemmatize(norm))
            if tokens:
                sentences.append(tokens)

        out: List[str] = []
        for n in self.orders:
            for tokens in sentences:
                for i in range(len(tokens) - n + 1):
                    out.append(" ".join(tokens[i : i + n]))
        return out
