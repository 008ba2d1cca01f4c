"""Porter2 (Snowball English) stemmer: the port's copy of
``mfar_tpu/sparse/stemmer.py`` (pure Python, numpy-free), so the port's BM25
tokenizes as the JAX package's does.

Algorithm: https://snowballstem.org/algorithms/english/stemmer.html
"""

from __future__ import annotations

from functools import lru_cache

_VOWELS = "aeiouy"
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDING = "cdeghkmnrt"

_EXCEPTIONS = {
    "skis": "ski",
    "skies": "sky",
    "dying": "die",
    "lying": "lie",
    "tying": "tie",
    "idly": "idl",
    "gently": "gentl",
    "ugly": "ugli",
    "early": "earli",
    "only": "onli",
    "singly": "singl",
    "sky": "sky",
    "news": "news",
    "howe": "howe",
    "atlas": "atlas",
    "cosmos": "cosmos",
    "bias": "bias",
    "andes": "andes",
}

_EXCEPTIONS_POST_1A = frozenset(
    ["inning", "outing", "canning", "herring", "earring", "proceed", "exceed", "succeed"]
)

# (suffix -> replacement) maps, longest-match-first ordering is applied at
# runtime by sorting on suffix length.
_STEP2 = [
    ("ization", "ize"),
    ("ational", "ate"),
    ("fulness", "ful"),
    ("ousness", "ous"),
    ("iveness", "ive"),
    ("tional", "tion"),
    ("biliti", "ble"),
    ("lessli", "less"),
    ("entli", "ent"),
    ("ation", "ate"),
    ("alism", "al"),
    ("aliti", "al"),
    ("ousli", "ous"),
    ("iviti", "ive"),
    ("fulli", "ful"),
    ("enci", "ence"),
    ("anci", "ance"),
    ("abli", "able"),
    ("izer", "ize"),
    ("ator", "ate"),
    ("alli", "al"),
    ("bli", "ble"),
    ("ogi", "og"),  # only when preceded by 'l'
    ("li", ""),  # only when preceded by a valid li-ending
]

_STEP3 = [
    ("ational", "ate"),
    ("tional", "tion"),
    ("alize", "al"),
    ("icate", "ic"),
    ("iciti", "ic"),
    ("ative", ""),  # only when in R2
    ("ical", "ic"),
    ("ness", ""),
    ("ful", ""),
]

_STEP4 = [
    "ement",
    "ance",
    "ence",
    "able",
    "ible",
    "ment",
    "ant",
    "ent",
    "ism",
    "ate",
    "iti",
    "ous",
    "ive",
    "ize",
    "ion",  # only when preceded by 's' or 't'
    "al",
    "er",
    "ic",
]


def _is_vowel(c: str) -> bool:
    return c in _VOWELS  # uppercase Y (consonant marker) is excluded


def _r1_start(word: str) -> int:
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            return len(prefix)
    for i in range(1, len(word)):
        if not _is_vowel(word[i]) and _is_vowel(word[i - 1]):
            return i + 1
    return len(word)


def _region_start_after(word: str, start: int) -> int:
    for i in range(start + 1, len(word)):
        if not _is_vowel(word[i]) and _is_vowel(word[i - 1]):
            return i + 1
    return len(word)


def _ends_short_syllable(word: str) -> bool:
    if len(word) == 2:
        return _is_vowel(word[0]) and not _is_vowel(word[1])
    if len(word) >= 3:
        c1, v, c2 = word[-3], word[-2], word[-1]
        return (
            not _is_vowel(c1)
            and _is_vowel(v)
            and not _is_vowel(c2)
            and c2 not in "wxY"
        )
    return False


def _contains_vowel(s: str) -> bool:
    return any(_is_vowel(c) for c in s)


@lru_cache(maxsize=1 << 20)
def porter2_stem(word: str) -> str:
    word = word.lower()
    if len(word) <= 2:
        return word
    if word[0] == "'":
        word = word[1:]
    if word in _EXCEPTIONS:
        return _EXCEPTIONS[word]

    # Mark consonant y's as Y.
    if word.startswith("y"):
        word = "Y" + word[1:]
    chars = list(word)
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
    word = "".join(chars)

    r1 = _r1_start(word)
    r2 = _region_start_after(word, r1)

    # Step 0: strip possessive endings.
    for suffix in ("'s'", "'s", "'"):
        if word.endswith(suffix):
            word = word[: -len(suffix)]
            break

    # Step 1a.
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith(("ied", "ies")):
        word = word[:-3] + ("i" if len(word) > 4 else "ie")
    elif word.endswith(("us", "ss")):
        pass
    elif word.endswith("s"):
        if _contains_vowel(word[:-2]):
            word = word[:-1]

    if word in _EXCEPTIONS_POST_1A:
        return word

    # Step 1b.
    step1b_suffixes = ("eedly", "ingly", "edly", "eed", "ing", "ed")
    for suffix in step1b_suffixes:
        if word.endswith(suffix):
            if suffix in ("eed", "eedly"):
                if len(word) - len(suffix) >= r1:
                    word = word[: -len(suffix)] + "ee"
            else:
                stem = word[: -len(suffix)]
                if _contains_vowel(stem):
                    word = stem
                    if word.endswith(("at", "bl", "iz")):
                        word += "e"
                    elif word.endswith(_DOUBLES):
                        word = word[:-1]
                    elif r1 >= len(word) and _ends_short_syllable(word):
                        word += "e"
            break

    # Step 1c: y -> i after a non-vowel that is not the first letter.
    if (
        len(word) > 2
        and word[-1] in "yY"
        and not _is_vowel(word[-2])
    ):
        word = word[:-1] + "i"

    # Step 2 (longest match; apply only if the suffix lies in R1).
    for suffix, repl in _STEP2:
        if word.endswith(suffix):
            if len(word) - len(suffix) >= r1:
                if suffix == "ogi":
                    if word.endswith("logi"):
                        word = word[:-1]
                elif suffix == "li":
                    if len(word) >= 3 and word[-3] in _LI_ENDING:
                        word = word[:-2]
                else:
                    word = word[: -len(suffix)] + repl
            break

    # Step 3.
    for suffix, repl in _STEP3:
        if word.endswith(suffix):
            if len(word) - len(suffix) >= r1:
                if suffix == "ative":
                    if len(word) - len(suffix) >= r2:
                        word = word[: -len(suffix)]
                else:
                    word = word[: -len(suffix)] + repl
            break

    # Step 4.
    for suffix in _STEP4:
        if word.endswith(suffix):
            if len(word) - len(suffix) >= r2:
                if suffix == "ion":
                    if len(word) >= 4 and word[-4] in "st":
                        word = word[:-3]
                else:
                    word = word[: -len(suffix)]
            break

    # Step 5.
    if word.endswith("e"):
        if len(word) - 1 >= r2:
            word = word[:-1]
        elif len(word) - 1 >= r1 and not _ends_short_syllable(word[:-1]):
            word = word[:-1]
    elif word.endswith("l"):
        if len(word) - 1 >= r2 and len(word) >= 2 and word[-2] == "l":
            word = word[:-1]

    return word.replace("Y", "y")
