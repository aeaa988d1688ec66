"""Text frontend: grapheme→phoneme tokenization with a g2p_en-compatible vocabulary.

The reference builds its vocab from ``g2p_en.G2p().phonemes`` plus space/comma/period
(the reference's ``valle/data.py:18-25``).  That inventory is the public CMUdict
ARPAbet set (stressed vowels + consonants) with 4 special tokens — reproduced here as a
constant so token IDs are stable whether or not ``g2p_en`` is installed.

When ``g2p_en`` is importable we use it (exact reference behaviour).  Otherwise the
fallback is a two-tier G2P: (1) the bundled pronunciation lexicon
(``data/lexicon.py`` — hand-checked CMUdict-notation entries for high-frequency
English words, with -s/-ed/-ing/-ly/-er suffix morphology), then (2) a
deterministic letter-to-sound rule engine for out-of-vocabulary words (magic-e,
vowel/consonant digraphs, common suffixes).  Tier 2 is approximate by nature and
flagged as such.
"""

from __future__ import annotations

import re
from functools import lru_cache

import numpy as np

# Bump when tokenization output changes (vocab, lexicon, normalization rules):
# keys the persistent codec-token disk cache (data/dataset.py), which stores
# tokenized transcripts alongside codes.
FRONTEND_VERSION = 1

# g2p_en's specials + CMUdict ARPAbet phoneme inventory (stress-marked vowels).
_SPECIALS = ['<pad>', '<unk>', '<s>', '</s>']
_VOWELS = ['AA', 'AE', 'AH', 'AO', 'AW', 'AY', 'EH', 'ER', 'EY', 'IH', 'IY', 'OW',
           'OY', 'UH', 'UW']
_CONSONANTS = ['B', 'CH', 'D', 'DH', 'F', 'G', 'HH', 'JH', 'K', 'L', 'M', 'N', 'NG',
               'P', 'R', 'S', 'SH', 'T', 'TH', 'V', 'W', 'Y', 'Z', 'ZH']
PHONEMES = (_SPECIALS
            + sorted([f'{v}{s}' for v in _VOWELS for s in (0, 1, 2)])
            + sorted(_CONSONANTS))
# The reference appends ' ', ',', '.' after the phoneme list (data.py:20-22).
PUNCTUATION = [' ', ',', '.']

# Letter→ARPAbet rules for out-of-lexicon words (tier-2 fallback).
_LETTER_RULES: dict[str, list[str]] = {
    'a': ['AE1'], 'b': ['B'], 'c': ['K'], 'd': ['D'], 'e': ['EH1'], 'f': ['F'],
    'g': ['G'], 'h': ['HH'], 'i': ['IH1'], 'j': ['JH'], 'k': ['K'], 'l': ['L'],
    'm': ['M'], 'n': ['N'], 'o': ['AA1'], 'p': ['P'], 'q': ['K', 'W'], 'r': ['R'],
    's': ['S'], 't': ['T'], 'u': ['AH1'], 'v': ['V'], 'w': ['W'], 'x': ['K', 'S'],
    'y': ['Y'], 'z': ['Z'],
}
# Long (tense) vowels for the magic-e rule: 'make' -> M EY1 K.
_LONG_VOWELS = {'a': 'EY1', 'e': 'IY1', 'i': 'AY1', 'o': 'OW1', 'u': 'UW1'}
# Multi-letter graphemes, longest-match-first (4, 3, then 2 letters).
_DIGRAPHS: dict[str, list[str]] = {
    'tion': ['SH', 'AH0', 'N'], 'sion': ['ZH', 'AH0', 'N'],
    'ough': ['AO1'], 'augh': ['AO1'],
    'igh': ['AY1'], 'eau': ['OW1'], 'dge': ['JH'], 'tch': ['CH'],
    'ch': ['CH'], 'sh': ['SH'], 'th': ['TH'], 'ph': ['F'], 'ng': ['NG'],
    'wh': ['W'], 'wr': ['R'], 'kn': ['N'], 'gn': ['N'], 'ck': ['K'],
    'qu': ['K', 'W'],
    'ee': ['IY1'], 'ea': ['IY1'], 'oo': ['UW1'], 'ou': ['AW1'], 'ow': ['OW1'],
    'oa': ['OW1'], 'ai': ['EY1'], 'ay': ['EY1'], 'ey': ['EY1'], 'oi': ['OY1'],
    'oy': ['OY1'], 'au': ['AO1'], 'aw': ['AO1'], 'ar': ['AA1', 'R'],
    'or': ['AO1', 'R'], 'er': ['ER0'], 'ir': ['ER1'], 'ur': ['ER1'],
}


class PhonemeTokenizer:
    """symbol↔id mapping identical to the reference's ``sym2idx`` construction."""

    def __init__(self, use_g2p: bool | None = None):
        self.sym2idx: dict[str, int] = {}
        self._g2p = None
        if use_g2p is not False:
            try:
                from g2p_en import G2p  # optional; not in this image
                self._g2p = G2p()
            except Exception:
                if use_g2p is True:
                    raise
        phonemes = list(self._g2p.phonemes) if self._g2p is not None else PHONEMES
        for sym in phonemes:
            self.sym2idx[sym] = len(self.sym2idx)
        for sym in PUNCTUATION:
            self.sym2idx[sym] = len(self.sym2idx)
        self.idx2sym = {v: k for k, v in self.sym2idx.items()}

    @property
    def vocab_size(self) -> int:
        return len(self.sym2idx)

    def phonemize(self, text: str) -> list[str]:
        if self._g2p is not None:
            return list(self._g2p(text))
        return _fallback_phonemize(text)

    def __call__(self, text: str) -> np.ndarray:
        """Text → int32 phoneme ids (reference ValleDataset._tokenize, data.py:24-25).
        Unknown symbols map to <unk> (the reference would KeyError)."""
        unk = self.sym2idx.get('<unk>', 1)
        return np.asarray([self.sym2idx.get(p, unk) for p in self.phonemize(text)],
                          dtype=np.int32)

    def decode(self, ids) -> list[str]:
        return [self.idx2sym.get(int(i), '<unk>') for i in ids]

    def to_text(self, ids) -> str:
        """Phoneme ids → English text via the inverse lexicon (the ASR output
        direction; see ``phonemes_to_text``)."""
        return phonemes_to_text(self.decode(ids))


_CONS_LETTERS = set('bcdfghjklmnpqrstvwxz')

# ---------------------------------------------------------------------------
# Text normalization (numbers, currency, percent) — g2p_en runs its own
# ``normalize_numbers`` before phonemizing; the fallback path needs an
# equivalent or digits silently disappear ("i have 3 cats" → "i have cats").
# ---------------------------------------------------------------------------

_ONES = ['zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven', 'eight',
         'nine', 'ten', 'eleven', 'twelve', 'thirteen', 'fourteen', 'fifteen',
         'sixteen', 'seventeen', 'eighteen', 'nineteen']
_TENS = ['', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty', 'seventy',
         'eighty', 'ninety']
_SCALES = [(10 ** 12, 'trillion'), (10 ** 9, 'billion'), (10 ** 6, 'million'),
           (10 ** 3, 'thousand'), (100, 'hundred')]


def _int_to_words(n: int) -> str:
    """Standard English reading of a non-negative integer (< 10^15)."""
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (f' {_ONES[rem]}' if rem else '')
    for base, name in _SCALES:
        if n >= base:
            head, rem = divmod(n, base)
            out = f'{_int_to_words(head)} {name}'
            return out + (f' {_int_to_words(rem)}' if rem else '')
    return _ONES[0]


def _number_to_words(token: str) -> str:
    """'3.5' → 'three point five'; '1,250' → 'one thousand two hundred fifty'."""
    token = token.replace(',', '')
    if '.' in token:
        whole, frac = token.split('.', 1)
        digits = ' '.join(_ONES[int(c)] for c in frac if c.isdigit())
        head = _int_to_words(int(whole)) if whole else 'zero'
        return f'{head} point {digits}' if digits else head
    return _int_to_words(int(token))


def _money_to_words(token: str) -> str:
    """'$1' → 'one dollar'; '$3.50' → 'three dollars fifty cents';
    '$1.01' → 'one dollar one cent'."""
    token = token.replace(',', '')
    whole, _, frac = token.partition('.')
    dollars = int(whole) if whole else 0
    cents = int(frac[:2].ljust(2, '0')) if frac else 0
    parts = []
    if dollars or not cents:
        unit = 'dollar' if dollars == 1 else 'dollars'
        parts.append(f'{_int_to_words(dollars)} {unit}')
    if cents:
        unit = 'cent' if cents == 1 else 'cents'
        parts.append(f'{_int_to_words(cents)} {unit}')
    return ' '.join(parts)


def normalize_text(text: str) -> str:
    """Expand digits/currency/percent into words; break hyphenated compounds.

    Mirrors the intent of g2p_en's ``normalize_numbers`` pre-pass so the
    no-dependency fallback never drops spoken content."""
    text = re.sub(r'\$\s*(\d[\d,]*(?:\.\d+)?)',
                  lambda m: _money_to_words(m.group(1)), text)
    text = re.sub(r'(\d[\d,]*(?:\.\d+)?)\s*%',
                  lambda m: f'{_number_to_words(m.group(1))} percent', text)
    text = re.sub(r'\d[\d,]*(?:\.\d+)?',
                  lambda m: _number_to_words(m.group(0)), text)
    text = re.sub(r'(?<=[a-zA-Z])-(?=[a-zA-Z])', ' ', text)
    text = text.replace('&', ' and ')
    return text


# Abbreviations whose trailing period does not end a sentence.  Lowercased,
# period-stripped.  Kept deliberately small: a false negative merely merges
# two sentences into one synthesis segment.
_ABBREVIATIONS = frozenset(
    'mr mrs ms dr prof sr jr st vs etc eg ie e.g i.e no inc ltd co corp '
    'ave blvd rd ft lt col gen capt sgt maj rev hon pres gov sen rep'.split())

_SENT_BOUNDARY = re.compile(r'([.!?]+)(\s+|$)')


def split_sentences(text: str, max_words: int = 80) -> list[str]:
    """Segment ``text`` into sentences for long-form synthesis.

    Splits on ``. ! ?`` followed by whitespace/end, keeping the punctuation
    with its sentence; a period after a known abbreviation (``Mr.``,
    ``e.g.``) or between digits (``3.5``, handled by requiring whitespace
    after the boundary) does not split.  Sentences longer than ``max_words``
    are hard-split at comma/semicolon boundaries (then word boundaries) so a
    single run-on can't exceed one AR decode budget.  Whitespace-only input
    returns ``[]``; text without sentence-final punctuation is one sentence.
    """
    text = ' '.join(text.split())
    if not text:
        return []
    sents: list[str] = []
    start = 0
    for m in _SENT_BOUNDARY.finditer(text):
        prev = text[start:m.end(1)]
        last = prev[:m.start(1) - start].rstrip().rsplit(' ', 1)[-1]
        w = last.lower().rstrip('.')
        if w in _ABBREVIATIONS or \
                (len(w) == 1 and w.isalpha() and last[:1].isupper()):
            continue        # "Mr." / "e.g." / an initial ("J. K. Rowling")
        if prev.strip():
            sents.append(prev.strip())
        start = m.end()
    if text[start:].strip():
        sents.append(text[start:].strip())

    out: list[str] = []
    for s in sents:
        words = s.split()
        while len(words) > max_words:
            # Prefer the clause boundary (comma/semicolon/colon) nearest the
            # cap; fall back to a plain word split at the cap.
            cut = max_words
            for i in range(min(max_words, len(words)) - 1, 0, -1):
                if words[i].endswith((',', ';', ':')):
                    cut = i + 1
                    break
            out.append(' '.join(words[:cut]))
            words = words[cut:]
        if words:
            out.append(' '.join(words))
    return out


@lru_cache(maxsize=4096)
def _word_to_phonemes(word: str) -> tuple[str, ...]:
    """Tier 1: bundled lexicon (+suffix morphology).  Tier 2: letter-to-sound rules
    with magic-e, multi-letter graphemes (longest match first), and double-letter
    collapsing.  Tier 2 is approximate by design."""
    from .lexicon import lookup
    hit = lookup(word)
    if hit is not None:
        return hit

    out: list[str] = []
    i = 0
    n = len(word)
    while i < n:
        # Magic-e: single vowel + single consonant + final silent 'e'.
        if (i + 2 == n - 1 and word[i] in _LONG_VOWELS
                and word[i + 1] in _CONS_LETTERS and word[i + 1] not in 'wxy'
                and word[n - 1] == 'e'):
            out.append(_LONG_VOWELS[word[i]])
            out.extend(_LETTER_RULES.get(word[i + 1], []))
            break
        matched = False
        for size in (4, 3, 2):
            piece = word[i:i + size]
            if len(piece) == size and piece in _DIGRAPHS:
                out.extend(_DIGRAPHS[piece])
                i += size
                matched = True
                break
        if matched:
            continue
        ch = word[i]
        if i + 1 < n and word[i + 1] == ch and ch in _CONS_LETTERS:
            i += 1                                     # collapse double consonants
            continue
        out.extend(_LETTER_RULES.get(ch, []))
        i += 1
    return tuple(out)


def _fallback_phonemize(text: str) -> list[str]:
    """Deterministic no-g2p_en G2P: normalize (numbers → words), then lexicon,
    then letter-to-sound rules for OOV."""
    tokens: list[str] = []
    text = normalize_text(text)
    for piece in re.findall(r"[a-zA-Z']+|[,.]|\s+", text):
        if piece.isspace():
            tokens.append(' ')
        elif piece in (',', '.'):
            tokens.append(piece)
        else:
            tokens.extend(_word_to_phonemes(piece.lower()))
    return tokens


def phonemes_to_text(symbols) -> str:
    """ARPAbet symbol stream (with ' '/','/'.' separators) → English text.

    The ASR direction's final step (BASELINE config #5: codec tokens → text):
    groups between separators invert through the bundled lexicon
    (``lexicon.invert_phonemes`` — exact match, then Viterbi segmentation,
    then hyphen-joined raw phonemes for OOV spans).  Punctuation attaches to
    the preceding word; specials act as separators and are dropped."""
    from .lexicon import invert_phonemes
    out: list[str] = []
    group: list[str] = []

    def flush():
        if group:
            out.extend(invert_phonemes(tuple(group)))
            group.clear()

    for s in symbols:
        if s == ' ' or s in _SPECIALS:
            flush()
        elif s in (',', '.'):
            flush()
            if out:
                out[-1] += s
            else:
                out.append(s)
        else:
            group.append(s)
    flush()
    return ' '.join(out)
